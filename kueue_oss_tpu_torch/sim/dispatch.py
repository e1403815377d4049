"""Cross-cluster dispatch pricing: one batched what-if solve per nomination.

A copy of ``kueue_oss_tpu/sim/dispatch.py``. The what-if-scored
MultiKueue dispatcher (``multikueue/dispatcher.py`` ``WhatIfDispatcher``)
asks, for ONE hub workload and K candidate worker clusters, what each
cluster's next admission drain does if the workload lands there, and
nominates the cluster with the best predicted outcome.

Each candidate is a different problem: its own cohort forest,
ClusterQueues, flavors and backlog. The lean drain is shape-static
gather/scatter arithmetic, so lanes of different clusters batch once
*canvas-normalized* to common shapes (``normalize_tensors``, on the
host in numpy, int32 kept):

- workload axis: ``pad_workloads`` to the widest lane (inert rows
  before the null row);
- node axis: inert rows inserted BEFORE the null row, every index that
  pointed at the old null remapped to the new last row;
- CQ axis: inert CQs (cq_node = the null node, StrictFIFO, one flavor
  option) that no workload maps to;
- flavor-resource / option axes: zero request columns and invalid
  option columns.

Every lane goes into ONE ``kernels.solve_backlog_batched`` call on
``device`` (the scenario axis padded to a power of two with inert
copies of lane 0) and comes back in one read. Each lane solves exactly
as it would alone; ``check_oracle=True`` re-solves each lane through
the sequential ``kernels.solve_backlog`` and records whether the batch
matched bit for bit. The scores (``LaneScore``: admitted, round,
``util_fraction`` from numpy sums of the read-back usage, in the JAX
package's order) are ranked on the host.

Scope: the lean drain only. A candidate needing the FULL drain
(preemption, several resource groups, AFS) or a TAS placement is
reported ``unpriceable`` and the dispatcher falls back to Incremental.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from kueue_oss_tpu_torch.core.workload_info import WorkloadInfo
from kueue_oss_tpu_torch.device import resolve_device
from kueue_oss_tpu_torch.solver.kernels import (
    ProblemTensors,
    host_tensors,
    solve_backlog,
    solve_backlog_batched,
)
from kueue_oss_tpu_torch.solver.tensors import (
    BIG,
    SolverProblem,
    UnsupportedProblem,
    export_problem,
    pad_workloads,
    pow2,
)

#: admit_round stand-in for "never admitted" when ordering scores
NEVER = 1 << 30


class Unpriceable(Exception):
    """This candidate cluster cannot be priced by the lean drain
    (FULL-drain shapes, TAS, no matching queue, export failure); the
    dispatcher must fall back, not guess."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


@dataclass
class LaneScore:
    """One candidate cluster's predicted outcome."""

    cluster: str
    admitted: bool
    admit_round: int          # NEVER when not admitted
    util_fraction: float      # post-plan CQ usage / nominal (scale-free)

    def key(self) -> tuple:
        """Sort key: admitted beats parked, earlier round beats later,
        then the LESS loaded cluster (spread), then name (stable)."""
        return (0 if self.admitted else 1,
                self.admit_round if self.admitted else NEVER,
                round(self.util_fraction, 9), self.cluster)


@dataclass
class DispatchReport:
    """Everything one priced nomination decided and why."""

    best: Optional[str] = None
    scores: list = field(default_factory=list)      # [LaneScore] ranked
    unpriceable: dict = field(default_factory=dict)  # cluster -> reason
    solve_seconds: float = 0.0
    batch_width: int = 0
    #: sequential-oracle agreement (check_oracle=True): the oracle's
    #: best cluster and whether every lane's plan was bit-identical
    oracle_best: Optional[str] = None
    oracle_identical: bool = True
    #: the port's own counters: the batched drain's rounds (the slowest
    #: lane's) and its host reads (one a round, one for the read-back)
    rounds: int = 0
    host_reads: int = 0


# ---------------------------------------------------------------------------
# per-cluster lane construction
# ---------------------------------------------------------------------------


def _is_tas_cq(store, cq_name: str) -> bool:
    spec = store.cluster_queues.get(cq_name)
    if spec is None:
        return False
    for rg in spec.resource_groups:
        for fq in rg.flavors:
            fl = store.resource_flavors.get(fq.name)
            if fl is not None and fl.topology_name is not None:
                return True
    return False


def _needs_full(env, cq_names) -> Optional[str]:
    """The lean drain's disqualifiers (``engine.needs_full_kernel``)
    over the CQs this lane would consult."""
    afs = getattr(env.queues, "afs", None)
    for name in cq_names:
        cq = env.store.cluster_queues.get(name)
        if cq is None:
            continue
        if cq.preemption.any_enabled:
            return f"preemption enabled on {name}"
        if len(cq.resource_groups) > 1:
            return f"multiple resource groups on {name}"
        if cq.admission_scope is not None and afs is not None:
            return f"admission fair sharing on {name}"
    return None


def _cluster_pending(env) -> dict[str, list[WorkloadInfo]]:
    """The worker's backlog per CQ in rank order (heap snapshot and the
    stale parked retries merged), without the TAS routing (TAS makes
    the lane unpriceable instead)."""
    from kueue_oss_tpu_torch.core.queue_manager import _order_key

    out: dict[str, list[WorkloadInfo]] = {}
    for name, q in env.queues.queues.items():
        if not q.active:
            continue
        stale = q.stale_infos() if q._stale else []
        infos = q.snapshot_order()
        if stale:
            infos = sorted(infos + stale, key=_order_key)
        if any(ps.topology_request is not None
               for i in infos for ps in i.obj.podsets):
            raise Unpriceable(f"topology-requesting backlog on {name}")
        if infos:
            out[name] = infos
    return out


def _candidate_info(wl, cq_name: str) -> WorkloadInfo:
    """The counterfactual arrival: a detached clone of the hub workload
    (the mirror's shape) ranked as the newest row of its CQ. Never
    added to the worker store."""
    from kueue_oss_tpu_torch.api.types import PodSet, Workload

    clone = Workload(
        name=wl.name, namespace=wl.namespace, queue_name=wl.queue_name,
        priority=wl.priority,
        podsets=[PodSet(
            name=ps.name, count=ps.count, requests=dict(ps.requests),
            min_count=ps.min_count,
            topology_request=ps.topology_request,
            node_selector=dict(ps.node_selector),
            tolerations=list(ps.tolerations),
        ) for ps in wl.podsets],
        creation_time=wl.creation_time, uid=wl.uid)
    return WorkloadInfo(clone, cluster_queue=cq_name)


def build_lane(env, wl, now: float = 0.0) -> tuple[SolverProblem, str]:
    """One cluster's counterfactual problem with the candidate landed.

    Returns (problem, candidate workload key); raises Unpriceable when
    this cluster cannot host or the lean drain cannot price it.
    """
    if any(ps.topology_request is not None for ps in wl.podsets):
        raise Unpriceable("candidate requests topology placement")
    lq = env.store.local_queues.get(f"{wl.namespace}/{wl.queue_name}")
    if lq is None:
        raise Unpriceable(f"no local queue {wl.queue_name!r}")
    cq_name = lq.cluster_queue
    if cq_name not in env.store.cluster_queues:
        raise Unpriceable(f"no cluster queue {cq_name!r}")
    pending = _cluster_pending(env)
    consulted = set(pending) | {cq_name}
    for name in consulted:
        if _is_tas_cq(env.store, name):
            raise Unpriceable(f"TAS flavors on {name}")
    reason = _needs_full(env, consulted)
    if reason is not None:
        raise Unpriceable(reason)
    cand = _candidate_info(wl, cq_name)
    if not any(i.key == cand.key for i in pending.get(cq_name, ())):
        # rank = position in the CQ's export list: last is "arrived
        # newest" in FIFO terms
        pending.setdefault(cq_name, []).append(cand)
    try:
        problem = export_problem(env.store, pending, now=now,
                                 columnar=False)
    except UnsupportedProblem as e:
        raise Unpriceable(f"export unsupported: {e}") from e
    if cand.key not in problem.wl_keys:
        raise Unpriceable("candidate dropped by the export")
    return problem, cand.key


# ---------------------------------------------------------------------------
# canvas normalization: different clusters, one batch
# ---------------------------------------------------------------------------


def _pad_rows(a: np.ndarray, fill, rows: int) -> np.ndarray:
    """Insert ``rows`` constant rows BEFORE the trailing null row."""
    if rows <= 0:
        return a
    filler = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a[:-1], filler, a[-1:]])


def _pad_axis(a: np.ndarray, axis: int, n: int, fill) -> np.ndarray:
    if n <= 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, n)
    return np.pad(a, widths, constant_values=fill)


def normalize_tensors(p: SolverProblem, N1: int, D: int, C: int,
                      F: int, K: int) -> ProblemTensors:
    """Canvas-normalize one lane's problem to the batch's common shapes
    and return its host (numpy) ProblemTensors. The added rows and
    columns are inert: no workload maps to a pad CQ, pad nodes hang off
    the null parent with zero quota, and zero request columns fit
    trivially, so the lane's plan is the un-normalized problem's."""
    t = host_tensors(p)
    old_null = t.parent.shape[0] - 1
    new_null = N1 - 1
    padn = new_null - old_null
    C_old = t.cq_node.shape[0]

    def remap(a: np.ndarray) -> np.ndarray:
        return np.where(a == old_null, new_null, a).astype(a.dtype)

    path = _pad_axis(remap(t.path), 1, D - t.path.shape[1], new_null)
    cq_node = np.concatenate(
        [remap(t.cq_node),
         np.full(C - C_old, new_null, dtype=t.cq_node.dtype)])
    is_cq = np.zeros(N1, dtype=bool)
    is_cq[cq_node] = True
    f_pad = F - t.nominal.shape[1]
    k_pad = K - t.wl_valid.shape[1]
    return ProblemTensors(
        parent=_pad_rows(remap(t.parent), new_null, padn),
        depth=_pad_rows(t.depth, 0, padn),
        height=_pad_rows(t.height, 0, padn),
        has_parent=_pad_rows(t.has_parent, False, padn),
        is_cq=is_cq,
        path=_pad_rows(path, new_null, padn),
        subtree=_pad_rows(_pad_axis(t.subtree, 1, f_pad, 0), 0, padn),
        local_quota=_pad_rows(
            _pad_axis(t.local_quota, 1, f_pad, 0), 0, padn),
        nominal=_pad_rows(_pad_axis(t.nominal, 1, f_pad, 0), 0, padn),
        has_borrow=_pad_rows(
            _pad_axis(t.has_borrow, 1, f_pad, False), False, padn),
        borrow_limit=_pad_rows(
            _pad_axis(t.borrow_limit, 1, f_pad, BIG), BIG, padn),
        usage0=_pad_rows(_pad_axis(t.usage0, 1, f_pad, 0), 0, padn),
        cq_node=cq_node,
        cq_strict=_pad_axis(t.cq_strict, 0, C - C_old, True),
        cq_try_next=_pad_axis(t.cq_try_next, 0, C - C_old, False),
        cq_nflavors=_pad_axis(t.cq_nflavors, 0, C - C_old, 1),
        # the null CQ id moves with the CQ axis: C_old -> C
        wl_cqid=np.where(t.wl_cqid == C_old, C,
                         t.wl_cqid).astype(t.wl_cqid.dtype),
        wl_rank=t.wl_rank,
        wl_prio=t.wl_prio,
        wl_ts=t.wl_ts,
        wl_uid=t.wl_uid,
        wl_req=_pad_axis(_pad_axis(t.wl_req, 1, k_pad, 0), 2, f_pad, 0),
        wl_valid=_pad_axis(t.wl_valid, 1, k_pad, False),
    )


def _lane_score(name: str, out: tuple, row: int,
                t: ProblemTensors) -> LaneScore:
    """A lane's score from its read-back outputs (numpy), with the JAX
    package's host arithmetic: numpy sums, then one float division."""
    admitted = bool(np.asarray(out[0])[row])
    admit_round = (int(np.asarray(out[2])[row]) if admitted else NEVER)
    usage = np.asarray(out[5])
    cq_rows = np.asarray(t.cq_node)
    used = float(usage[cq_rows].sum())
    cap = float(np.asarray(t.nominal)[cq_rows].sum())
    return LaneScore(cluster=name, admitted=admitted,
                     admit_round=admit_round,
                     util_fraction=(used / cap) if cap > 0 else 0.0)


def _upload(t: ProblemTensors, device) -> ProblemTensors:
    return ProblemTensors(*(torch.tensor(np.ascontiguousarray(a),
                                         device=device) for a in t))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def price_dispatch(wl, environments: dict, now: float = 0.0,
                   check_oracle: bool = False,
                   device="cuda") -> DispatchReport:
    """Score every candidate cluster with ONE batched what-if drain on
    ``device``.

    ``environments`` maps cluster name -> WorkerEnvironment (or any
    object with ``.store`` and ``.queues``). ``report.best`` is None
    when no lane was priceable (the dispatcher then falls back).
    ``check_oracle=True`` also solves every lane through the sequential
    drain and records whether the batch matched bit for bit.
    """
    report = DispatchReport()
    lanes: list[tuple[str, SolverProblem, str]] = []
    for name in sorted(environments):
        try:
            problem, key = build_lane(environments[name], wl, now=now)
            lanes.append((name, problem, key))
        except Unpriceable as e:
            report.unpriceable[name] = e.reason
    if not lanes:
        return report
    dev = resolve_device(device)
    W = pow2(max(p.n_workloads for _, p, _ in lanes))
    lanes = [(n, pad_workloads(p, W), k) for n, p, k in lanes]
    N1 = max(p.parent.shape[0] for _, p, _ in lanes)
    D = max(p.path.shape[1] for _, p, _ in lanes)
    C = max(p.n_cqs for _, p, _ in lanes)
    F = max(p.nominal.shape[1] for _, p, _ in lanes)
    K = max(p.wl_valid.shape[1] for _, p, _ in lanes)
    tensors = [normalize_tensors(p, N1, D, C, F, K)
               for _, p, _ in lanes]
    rows = [p.wl_keys.index(k) for _, p, k in lanes]
    S = len(lanes)
    target_s = pow2(S)
    stacked = {}
    for f in ProblemTensors._fields:
        arrs = [getattr(t, f) for t in tensors]
        arrs += [arrs[0]] * (target_s - S)  # inert pow2 repeats
        stacked[f] = np.stack(arrs)
    base = _upload(tensors[0], dev)
    counts = {"host_reads": 0}
    t0 = time.monotonic()
    out = solve_backlog_batched(base, stacked, counts)
    out = tuple(a.cpu().numpy() for a in out)
    report.solve_seconds = time.monotonic() - t0
    report.batch_width = target_s
    report.rounds = int(out[4].max())
    report.host_reads = counts["host_reads"] + 1
    scores = [
        _lane_score(name, tuple(a[i] for a in out), rows[i], tensors[i])
        for i, (name, _, _) in enumerate(lanes)]
    report.scores = sorted(scores, key=LaneScore.key)
    report.best = report.scores[0].cluster
    if check_oracle:
        oracle_scores = []
        for i, (name, _, _) in enumerate(lanes):
            o = tuple(a.cpu().numpy()
                      for a in solve_backlog(_upload(tensors[i], dev)))
            for pos, a in enumerate(o):
                if not np.array_equal(a, out[pos][i]):
                    report.oracle_identical = False
            oracle_scores.append(
                _lane_score(name, o, rows[i], tensors[i]))
        oracle_scores.sort(key=LaneScore.key)
        report.oracle_best = oracle_scores[0].cluster
    return report

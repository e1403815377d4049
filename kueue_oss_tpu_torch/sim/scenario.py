"""Scenario layer: declarative perturbations over a base problem.

A copy of ``kueue_oss_tpu/sim/scenario.py`` (host numpy) on the port's
``SolverProblem``; the batched drain it feeds is
``kueue_oss_tpu_torch.solver.kernels.solve_backlog_batched``.

A :class:`ScenarioSpec` is a deterministic, JSON-round-trippable recipe
for ONE counterfactual world: quota scaled for some ClusterQueues or
cohorts, the backlog arriving faster or slower, priorities shifted or
churned, nodes flapping on a virtual-time schedule (the chaos
``NodeFlapInjector`` shapes, replayed without sleeps). The what-if
engine turns a list of specs into stacked tensor overlays and solves
them all in one batched device drain (sim/batch.py), so "what would
the cluster do if" is answered at hardware speed instead of one
simulation per question (Gavel, arXiv:2008.09213, argues policy
questions need a faithful simulator of the real scheduler; CvxCluster,
arXiv:2605.01614, shows batching allocation problems onto accelerators
makes them interactive).

Quota-scaling semantics: scaling a node's quota by ``f`` scales its
whole quota contract — nominal, borrowing limit, and the implied
lending gap — then the derived ``subtree``/``local_quota``/cohort-usage
arrays are recomputed bottom-up with the exact formulas the snapshot
layer uses (core/quota.py: subtree = nominal + Σ child (subtree −
local); cohort usage = Σ child max(0, usage − local)), so a scaled
scenario is indistinguishable from a cluster that really had that
quota.
"""

from __future__ import annotations

import fnmatch
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np

from kueue_oss_tpu_torch.solver.tensors import (
    BIG,
    MAX_QUANTITY,
    SolverProblem,
)

#: ceiling for scaled quota quantities (the exporter's overflow guard)
_QMAX = MAX_QUANTITY - 1


@dataclass
class FlapEvent:
    """One node-readiness flip on the virtual-time schedule (trace
    mode). ``names=()`` means a seeded sample of ``count`` ready nodes,
    exactly like ``NodeFlapInjector.flap_down``."""

    at_ms: float
    down: bool = True
    count: int = 1
    names: tuple = ()

    def to_dict(self) -> dict:
        return {"atMs": self.at_ms, "down": self.down,
                "count": self.count, "names": list(self.names)}

    @classmethod
    def from_dict(cls, d: dict) -> "FlapEvent":
        return cls(at_ms=float(d.get("atMs", 0.0)),
                   down=bool(d.get("down", True)),
                   count=int(d.get("count", 1)),
                   names=tuple(d.get("names", ())))


@dataclass
class ScenarioSpec:
    """One counterfactual world, applied over a base problem/store.

    - ``quota_scale``: node-name glob pattern (CQ or cohort name) ->
      multiplicative factor on that node's quota contract.
    - ``arrival_scale``: fraction of the backlog present at the
      planning instant, by per-CQ arrival (creation-time) order.
      ``0.5`` = only the earlier half arrived; ``2.0`` = the backlog
      arrived twice as fast, so twice as much of it is already here
      (the engine materializes clone arrivals for factors above 1).
    - ``priority_shift``: CQ-name glob pattern -> additive priority
      delta for that CQ's pending workloads.
    - ``priority_churn_fraction`` / ``priority_churn_delta``: a seeded
      random ``fraction`` of pending workloads get ``delta`` added to
      their priority (priority-mix churn).
    - ``node_flaps``: virtual-time readiness schedule (trace mode).
    - ``seed``: drives every sampled choice; same seed + same spec =>
      byte-identical overlay, and therefore a byte-identical report.
    """

    name: str = "base"
    quota_scale: dict = field(default_factory=dict)
    arrival_scale: float = 1.0
    priority_shift: dict = field(default_factory=dict)
    priority_churn_fraction: float = 0.0
    priority_churn_delta: int = 0
    node_flaps: list = field(default_factory=list)
    seed: int = 0

    def validate(self) -> None:
        import math

        # non-finite factors must fail loudly: NaN compares False
        # against every bound, collides with the matcher's NaN
        # sentinel, and int-casts to garbage cutoffs — the exact
        # "silently different sweep" this layer exists to prevent
        for pat, f in self.quota_scale.items():
            if (not isinstance(pat, str) or not math.isfinite(float(f))
                    or float(f) < 0):
                raise ValueError(
                    f"scenario {self.name}: quota_scale[{pat!r}] must "
                    "be a finite non-negative factor")
        if (not math.isfinite(float(self.arrival_scale))
                or self.arrival_scale < 0):
            raise ValueError(
                f"scenario {self.name}: arrival_scale must be a "
                "finite factor >= 0")
        if not 0.0 <= self.priority_churn_fraction <= 1.0:
            raise ValueError(
                f"scenario {self.name}: priority_churn_fraction must "
                "be within [0, 1]")

    def to_dict(self) -> dict:
        d = asdict(self)
        d["node_flaps"] = [
            fe.to_dict() if isinstance(fe, FlapEvent) else fe
            for fe in self.node_flaps]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        return cls(
            name=str(d.get("name", "base")),
            quota_scale={str(k): float(v)
                         for k, v in (d.get("quota_scale") or {}).items()},
            arrival_scale=float(d.get("arrival_scale", 1.0)),
            priority_shift={str(k): int(v)
                            for k, v in (d.get("priority_shift")
                                         or {}).items()},
            priority_churn_fraction=float(
                d.get("priority_churn_fraction", 0.0)),
            priority_churn_delta=int(d.get("priority_churn_delta", 0)),
            node_flaps=[FlapEvent.from_dict(fe)
                        for fe in (d.get("node_flaps") or [])],
            seed=int(d.get("seed", 0)))

    # -- tensor overlay ----------------------------------------------------

    def overlay(self, problem: SolverProblem, replicas: int = 1,
                arrival_idx: Optional[np.ndarray] = None) -> dict:
        """The per-field tensor overrides this scenario needs, as full
        replacement arrays (only fields that actually change). The
        batched solver stacks these along the scenario axis.

        ``replicas`` is how many arrival copies of each original
        workload the engine materialized into the problem (for
        arrival_scale > 1 sweeps); every scenario then masks the union
        backlog down to its own cutoff — including the base scenario,
        which keeps only the originals. ``arrival_idx`` lets sweep
        callers hoist the O(W) :func:`arrival_order` computation out
        of the per-scenario loop (it depends only on the base
        problem)."""
        out: dict[str, np.ndarray] = {}
        if self.quota_scale:
            out.update(_quota_overlay(problem, self.quota_scale))
        if self.arrival_scale != 1.0 or replicas > 1:
            out.update(_arrival_overlay(problem, self.arrival_scale,
                                        replicas, arrival_idx))
        prio = _priority_overlay(
            problem, self.priority_shift, self.priority_churn_fraction,
            self.priority_churn_delta, self.seed)
        if prio is not None:
            out["wl_prio"] = prio
        return out


# ---------------------------------------------------------------------------
# sweep constructors
# ---------------------------------------------------------------------------


def quota_sweep(factors, target: str = "*", seed: int = 0,
                ) -> list[ScenarioSpec]:
    """One scenario per quota factor on the matched nodes, plus the
    unperturbed base as scenario 0 (the comparison anchor)."""
    specs = [ScenarioSpec(name="base", seed=seed)]
    for f in factors:
        specs.append(ScenarioSpec(
            name=f"quota[{target}]x{f:g}", seed=seed,
            quota_scale={target: float(f)}))
    return specs


def arrival_sweep(factors, seed: int = 0) -> list[ScenarioSpec]:
    specs = [ScenarioSpec(name="base", seed=seed)]
    for f in factors:
        specs.append(ScenarioSpec(
            name=f"arrival-x{f:g}", seed=seed, arrival_scale=float(f)))
    return specs


def cross(a: list[ScenarioSpec], b: list[ScenarioSpec],
          ) -> list[ScenarioSpec]:
    """Cartesian product of two sweeps (quota x arrival grids)."""
    out = []
    for sa in a:
        for sb in b:
            out.append(ScenarioSpec(
                name=(sa.name if sb.name == "base" else
                      sb.name if sa.name == "base" else
                      f"{sa.name}+{sb.name}"),
                quota_scale={**sa.quota_scale, **sb.quota_scale},
                arrival_scale=sa.arrival_scale * sb.arrival_scale,
                priority_shift={**sa.priority_shift, **sb.priority_shift},
                priority_churn_fraction=max(sa.priority_churn_fraction,
                                            sb.priority_churn_fraction),
                priority_churn_delta=(sa.priority_churn_delta
                                      or sb.priority_churn_delta),
                node_flaps=list(sa.node_flaps) + list(sb.node_flaps),
                seed=sa.seed ^ (sb.seed << 1)))
    return out


def max_arrival_scale(specs) -> float:
    return max([s.arrival_scale for s in specs] + [1.0])


# ---------------------------------------------------------------------------
# overlay builders
# ---------------------------------------------------------------------------


def _match_factors(names: list[str], quota_scale: dict) -> np.ndarray:
    """Per-node multiplicative factor; later patterns win on overlap."""
    f = np.full(len(names), np.nan, dtype=np.float64)
    for pat, factor in quota_scale.items():
        hit = np.asarray([fnmatch.fnmatchcase(n, pat) for n in names])
        f[hit] = float(factor)
    return f


def _clip_quota(a: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(a), 0, _QMAX).astype(np.int32)


def _quota_overlay(problem: SolverProblem, quota_scale: dict) -> dict:
    """Scale matched nodes' quota contracts, then recompute the derived
    subtree / local_quota / cohort-usage arrays bottom-up (the exporter
    lays nodes out parents-first, so children always have the higher
    index)."""
    n_nodes = problem.n_nodes
    null = n_nodes
    # a matched COHORT scales its whole subtree ("the cohort's quota
    # doubled" — quota physically lives on the CQ leaves): factors
    # inherit parent -> child top-down (parents-first node order), a
    # child's own match overriding its inherited one
    matched = np.full(n_nodes + 1, np.nan, dtype=np.float64)
    matched[:n_nodes] = _match_factors(problem.node_names, quota_scale)
    factors = np.ones(n_nodes + 1, dtype=np.float64)
    parent0 = problem.parent
    for i in range(n_nodes):
        if not np.isnan(matched[i]):
            factors[i] = matched[i]
        elif parent0[i] != null:
            factors[i] = factors[parent0[i]]
    fcol = factors[:, None]

    nominal = _clip_quota(problem.nominal.astype(np.int64) * fcol)
    has_borrow = problem.has_borrow
    borrow_limit = np.where(
        has_borrow,
        _clip_quota(problem.borrow_limit.astype(np.int64) * fcol),
        BIG).astype(np.int32)
    # implied lending gap: subtree - local == min(lending_limit,
    # subtree); zero means "no lending limit" (local == subtree)
    gap0 = (problem.subtree.astype(np.int64)
            - problem.local_quota.astype(np.int64))
    gap = _clip_quota(gap0 * fcol).astype(np.int64)

    subtree = np.zeros_like(problem.subtree, dtype=np.int64)
    local = np.zeros_like(problem.local_quota, dtype=np.int64)
    acc = np.zeros_like(subtree)
    parent = problem.parent
    for i in range(n_nodes - 1, -1, -1):
        subtree[i] = nominal[i] + acc[i]
        local[i] = np.where(gap0[i] > 0,
                            np.maximum(0, subtree[i] - gap[i]),
                            subtree[i])
        p = parent[i]
        if p != null:
            acc[p] += subtree[i] - local[i]

    # cohort usage rows re-derive from CQ rows under the new local
    # quotas (refresh_cohort_usage's accumulate step, host-side)
    is_cq = np.zeros(n_nodes + 1, dtype=bool)
    is_cq[problem.cq_node] = True
    usage = np.where(is_cq[:, None], problem.usage0.astype(np.int64), 0)
    for i in range(n_nodes - 1, -1, -1):
        p = parent[i]
        if p != null:
            usage[p] += np.maximum(0, usage[i] - local[i])

    if (subtree.max(initial=0) >= MAX_QUANTITY
            or usage.max(initial=0) >= MAX_QUANTITY):
        raise ValueError(
            "scenario scales quota beyond the int32 solver headroom")
    return {
        "nominal": nominal,
        "borrow_limit": borrow_limit,
        "subtree": subtree.astype(np.int32),
        "local_quota": local.astype(np.int32),
        "usage0": usage.astype(np.int32),
    }


def arrival_order(problem: SolverProblem) -> np.ndarray:
    """Within-CQ arrival index per live row, by (creation ts, uid).
    Depends only on the base problem — sweep callers compute it once
    and pass it through ``ScenarioSpec.overlay(arrival_idx=...)``."""
    W = problem.n_workloads
    cqid = problem.wl_cqid[:W].astype(np.int64)
    live = cqid < problem.n_cqs
    raw_ts = (problem.wl_raw_ts[:W] if problem.wl_raw_ts is not None
              else problem.wl_ts[:W].astype(np.float64))
    uid = problem.wl_uid[:W].astype(np.int64)
    order = np.lexsort((uid, raw_ts, cqid))
    arrival_idx = np.full(W, np.iinfo(np.int64).max, dtype=np.int64)
    pos_in_cq = np.zeros(problem.n_cqs + 1, dtype=np.int64)
    for w in order:
        if not live[w]:
            continue
        c = cqid[w]
        arrival_idx[w] = pos_in_cq[c]
        pos_in_cq[c] += 1
    return arrival_idx


def _arrival_overlay(problem: SolverProblem, scale: float,
                     replicas: int = 1,
                     arrival_idx: Optional[np.ndarray] = None) -> dict:
    """Mask rows beyond each CQ's arrival-scaled cutoff into inert
    padding (the exact pad_workloads fills, so masked rows are
    indistinguishable from padding to the kernel). The union backlog
    holds ``replicas`` arrival copies per original (clones arrive after
    every original, so arrival order keeps originals first); the cutoff
    is ``ceil(scale x originals)`` per CQ."""
    W = problem.n_workloads
    C = problem.n_cqs
    cqid = problem.wl_cqid[:W].astype(np.int64)
    live = cqid < C
    if arrival_idx is None:
        arrival_idx = arrival_order(problem)
    n_cq = np.bincount(cqid[live], minlength=C + 1)
    n_orig = n_cq // max(1, int(replicas))
    cutoff = np.minimum(
        np.ceil(n_orig * float(scale)).astype(np.int64), n_cq)
    keep = np.ones(W + 1, dtype=bool)
    keep[:W] = ~live | (arrival_idx < cutoff[np.minimum(cqid, C)])
    if keep.all():
        return {}
    wl_cqid = problem.wl_cqid.copy()
    wl_rank = problem.wl_rank.copy()
    wl_valid = problem.wl_valid.copy()
    drop = ~keep
    drop[W] = False
    wl_cqid[drop] = C
    wl_rank[drop] = BIG
    wl_valid[drop] = False
    return {"wl_cqid": wl_cqid, "wl_rank": wl_rank, "wl_valid": wl_valid}


def _priority_overlay(problem: SolverProblem, shift: dict,
                      churn_fraction: float, churn_delta: int,
                      seed: int) -> Optional[np.ndarray]:
    if not shift and not (churn_fraction > 0 and churn_delta):
        return None
    W = problem.n_workloads
    prio = problem.wl_prio.astype(np.int64).copy()
    cqid = problem.wl_cqid[:W]
    live = cqid < problem.n_cqs
    if shift:
        delta_of_cq = np.zeros(problem.n_cqs + 1, dtype=np.int64)
        for pat, delta in shift.items():
            hit = np.asarray([fnmatch.fnmatchcase(n, pat)
                              for n in problem.cq_names] + [False])
            delta_of_cq[hit] = int(delta)
        prio[:W][live] += delta_of_cq[cqid[live]]
    if churn_fraction > 0 and churn_delta:
        rng = np.random.default_rng(seed)
        idx = np.nonzero(live)[0]
        n_pick = int(round(churn_fraction * idx.size))
        if n_pick:
            picked = rng.choice(idx, size=n_pick, replace=False)
            prio[picked] += int(churn_delta)
    return np.clip(prio, -(1 << 30), 1 << 30).astype(np.int32)

"""Report layer: per-scenario KPIs and the JSON what-if report.

A copy of ``kueue_oss_tpu/sim/report.py``: the same KPIs from the same
plans give a byte-identical ``canonical_json``.

Every KPI is computed host-side from the solved plan tensors plus the
problem's decode tables, with deterministic rounding — the acceptance
contract is *same seed + same specs => byte-identical report*, so
nothing time-of-day or float-nondeterministic may leak into the
scenario rows. Wall-clock measurements live in a separate ``timing``
block that :func:`canonical_json` excludes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from kueue_oss_tpu_torch.solver.tensors import SolverProblem

#: include per-CQ admitted breakdowns only up to this many CQs (a
#: 1000-CQ sweep must not emit megabyte reports)
PER_CQ_BREAKDOWN_MAX = 64


def _r(x: float, nd: int = 6) -> float:
    return float(round(float(x), nd))


def _pct(arr: np.ndarray, q: float) -> float:
    if arr.size == 0:
        return 0.0
    return _r(np.percentile(arr, q))


def borrow_stats(problem: SolverProblem, overlay: dict,
                 usage: np.ndarray) -> dict:
    """Per-scenario borrowing posture: how many CQs are borrowing and
    how many sit AT their borrowing ceiling — either their own
    borrowingLimit (``has_borrow``) or an exhausted cohort pool (root
    usage at subtree capacity). The JAX load ladder reads it as its
    third breaking-point signal ("first cohort at borrowing ceiling")."""
    C = problem.n_cqs
    if not C:
        return {"borrowing_cqs": 0, "cqs_at_borrow_ceiling": 0}
    cq_rows = problem.cq_node
    nominal = np.asarray(overlay.get("nominal", problem.nominal))
    blimit = np.asarray(
        overlay.get("borrow_limit", problem.borrow_limit))
    subtree = np.asarray(overlay.get("subtree", problem.subtree))
    has_b = np.asarray(problem.has_borrow)[cq_rows]
    u = np.maximum(usage[cq_rows], 0)
    nom = nominal[cq_rows]
    borrowing = (u > nom).any(axis=1)
    ceiling = nom + blimit[cq_rows]
    at_limit = has_b.reshape(-1, 1) & (u >= ceiling) & (u > nom)
    root = problem.cq_root
    pool_full = (np.maximum(usage[root], 0)
                 >= subtree[root]).any(axis=1)
    at_ceiling = borrowing & (at_limit.any(axis=1) | pool_full)
    return {"borrowing_cqs": int(borrowing.sum()),
            "cqs_at_borrow_ceiling": int(at_ceiling.sum())}


def scenario_kpis(problem: SolverProblem, spec, overlay: dict,
                  admitted: np.ndarray, opt: np.ndarray,
                  admit_round: np.ndarray, parked: np.ndarray,
                  rounds, usage: np.ndarray, now: float = 0.0,
                  tier: str = "lean",
                  victim_reason: np.ndarray = None) -> dict:
    """KPIs for one solved scenario.

    ``overlay`` is the scenario's field overrides — the effective
    wl_cqid (arrival masking) and quota arrays come from it when
    present, so KPIs describe the world the kernel actually solved.
    ``tier`` names the solve tier the row came from ("lean" fit-only
    batch / "full" preemption kernel / "relax" approximate LP);
    ``victim_reason`` (FULL tier) makes the preemption count real.
    """
    W = problem.n_workloads
    C = problem.n_cqs
    cqid = np.asarray(overlay.get("wl_cqid", problem.wl_cqid))[:W]
    subtree = np.asarray(overlay.get("subtree", problem.subtree))
    live = cqid < C
    adm = admitted[:W].astype(bool) & live
    prk = parked[:W].astype(bool) & live
    pending = live & ~adm

    n_live = int(live.sum())
    n_adm = int(adm.sum())
    n_parked = int(prk.sum())

    # utilization: committed CQ usage over the forest's total capacity
    root_rows = np.asarray(
        [i for i in range(problem.n_nodes)
         if not problem.has_parent[i]], dtype=np.int64)
    capacity = (int(subtree[root_rows].sum())
                if root_rows.size else 0)
    cq_rows = problem.cq_node
    used = int(np.maximum(usage[cq_rows], 0).sum())
    utilization = _r(used / capacity) if capacity else 0.0

    # fairness drift: spread of weighted dominant shares across CQs
    # that have any demand (usage over the root subtree capacity per
    # FR, divided by the CQ's fair weight — the DRS the fair-sharing
    # kernels order by, aggregated to one per-scenario number)
    root_of_cq = problem.cq_root
    cap_fr = np.maximum(subtree[root_of_cq].astype(np.float64), 1.0)
    shares = usage[cq_rows].astype(np.float64) / cap_fr
    dom = shares.max(axis=1)
    weights = np.maximum(
        np.asarray(problem.cq_fair_weight, dtype=np.float64), 1e-9)
    wdom = dom / weights
    active = (usage[cq_rows].sum(axis=1) > 0) | (
        np.bincount(cqid[live], minlength=C + 1)[:C] > 0)
    fairness_drift = _r(float(np.std(wdom[active]))
                        if active.any() else 0.0)

    # starvation/age: pending (not admitted) workloads by creation age
    raw_ts = (problem.wl_raw_ts[:W] if problem.wl_raw_ts is not None
              else problem.wl_ts[:W].astype(np.float64))
    ages = np.maximum(0.0, float(now) - raw_ts[pending])
    admit_rounds = admit_round[:W][adm]

    # the lean drain is fit-only by contract (preemptions stay 0);
    # the FULL tier reports real victims via victim_reason > 0
    preemptions = (int((victim_reason[:W] > 0).sum())
                   if victim_reason is not None else 0)

    kpis = {
        "name": spec.name,
        "spec": spec.to_dict(),
        "tier": tier,
        "workloads": n_live,
        "admitted": n_adm,
        "parked": n_parked,
        "pending": int(pending.sum()),
        "preemptions": preemptions,
        "admission_rate": _r(n_adm / n_live) if n_live else 0.0,
        "rounds": int(rounds),
        "utilization": utilization,
        "fairness_drift": fairness_drift,
        "starved": int(pending.sum()),
        "starvation_age_p50": _pct(ages, 50),
        "starvation_age_p95": _pct(ages, 95),
        "admit_round_p50": _pct(admit_rounds, 50),
        "admit_round_p95": _pct(admit_rounds, 95),
    }
    kpis.update(borrow_stats(problem, overlay, usage))
    if C <= PER_CQ_BREAKDOWN_MAX:
        per_cq = np.bincount(cqid[adm], minlength=C + 1)[:C]
        kpis["admitted_by_cq"] = {
            problem.cq_names[c]: int(per_cq[c])
            for c in range(C) if per_cq[c]}
    return kpis


@dataclass
class WhatIfReport:
    """The full what-if answer: base shape, per-scenario KPIs, the
    batched-vs-sequential parity verdict, and (non-canonical) timing."""

    base: dict = field(default_factory=dict)
    scenarios: list = field(default_factory=list)
    parity: dict = field(default_factory=dict)
    timing: dict = field(default_factory=dict)

    def to_dict(self, include_timing: bool = True) -> dict:
        d = {"base": self.base, "scenarios": self.scenarios,
             "parity": self.parity}
        if include_timing:
            d["timing"] = self.timing
        return d

    def canonical_json(self) -> str:
        """Deterministic serialization: same seed + same specs =>
        byte-identical output (timing excluded, keys sorted)."""
        return json.dumps(self.to_dict(include_timing=False),
                          sort_keys=True, separators=(",", ":"))

    def to_json(self, include_timing: bool = True, indent: int = 2,
                ) -> str:
        return json.dumps(self.to_dict(include_timing=include_timing),
                          sort_keys=True, indent=indent)

    def best_scenario(self, key: str = "admitted") -> dict:
        """The scenario maximizing a KPI (ties -> first in spec order);
        the capacity-planning 'which knob helps most' answer."""
        if not self.scenarios:
            return {}
        return max(self.scenarios, key=lambda s: (s.get(key, 0),))

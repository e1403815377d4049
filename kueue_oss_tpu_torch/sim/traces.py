"""Production-shaped traces + the breaking-point load ladder.

A copy of ``kueue_oss_tpu/sim/traces.py`` over the port's own API types
and ``Store``; the ladder's what-if sweeps run on the caller's device.

The what-if engine answers counterfactuals about a store; this module
builds the stores worth asking about. Capacity planning results are
only credible over production-shaped load (the Gavel / Aryl line of
work evaluates on the Microsoft Philly and SenseTime Helios cluster
traces), so the generator reproduces the moments those traces are
known for rather than uniform toy mixes:

- **durations**: log-normal with a heavy tail (median minutes, p99
  many hours);
- **GPU counts**: dominated by small jobs (1 GPU most common) with a
  power-of-two ladder up to distributed jobs — Philly ~80% and Helios
  ~88% single-GPU;
- **arrivals**: Poisson thinned by a diurnal intensity (quiet nights,
  busy afternoons);
- **tenancy**: jobs belong to virtual clusters (VCs) with zipf-ish
  popularity; each VC maps to a ClusterQueue under one shared cohort
  so borrowing mirrors the private-cluster + shared-pool model.

Everything is seeded and host-side deterministic: the same call
produces byte-identical traces, stores, and ladder reports.

The **load ladder** is the planning question the ROADMAP names: "what
breaks first as load doubles?" It sweeps ``arrival_scale`` over a
factor ladder through :class:`~kueue_oss_tpu_torch.sim.engine.WhatIfEngine`
(FULL kernel capable) and reports the first rung that burns the
admission SLO, breaches the starvation-age bound, or pins a cohort at
its borrowing ceiling.
"""

from __future__ import annotations

import csv
import json
import math
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np

#: trace schema (docs/SIMULATOR.md): one record per job
TRACE_FIELDS = ("job_id", "vc", "submit_s", "duration_s", "gpus",
                "priority")


@dataclass
class TraceJob:
    """One job record in Philly/Helios shape."""

    job_id: str
    vc: str
    submit_s: float
    duration_s: float
    gpus: int
    priority: int = 0

    def to_dict(self) -> dict:
        return asdict(self)


#: (gpu count, weight) ladders per trace shape — small-job dominated,
#: pow2 distributed sizes (Philly fig. 1 / Helios table 2 shapes)
_GPU_MIX = {
    "philly": ((1, 0.55), (2, 0.15), (4, 0.12), (8, 0.12),
               (16, 0.04), (32, 0.02)),
    "helios": ((1, 0.72), (2, 0.10), (4, 0.08), (8, 0.08),
               (16, 0.015), (32, 0.005)),
}

#: log-normal duration parameters (log-seconds mean/sigma): medians of
#: ~13 min (philly) / ~5 min (helios) with multi-hour p99 tails
_DURATION = {"philly": (6.7, 1.8), "helios": (5.7, 2.0)}


def synthetic_trace(n_jobs: int, seed: int = 0, shape: str = "philly",
                    n_vcs: int = 4, horizon_s: float = 86400.0,
                    ) -> list[TraceJob]:
    """Generate a deterministic Philly/Helios-shaped trace."""
    if shape not in _GPU_MIX:
        raise ValueError(f"unknown trace shape {shape!r} "
                         f"(known: {sorted(_GPU_MIX)})")
    rng = np.random.default_rng(seed)
    # diurnal Poisson arrivals: draw uniform times, thin against a
    # day-cycle intensity (trough 0.3x at 04:00, peak 1.7x at 16:00)
    times = np.sort(rng.uniform(0.0, horizon_s, size=4 * n_jobs))
    phase = 2.0 * math.pi * (times % 86400.0) / 86400.0
    intensity = 1.0 + 0.7 * np.sin(phase - 2.0 * math.pi * 10.0 / 24.0)
    keep = rng.uniform(0.0, 1.7, size=times.size) < intensity
    times = times[keep][:n_jobs]
    while times.size < n_jobs:  # thinning undershoot: top up uniform
        times = np.sort(np.concatenate([
            times, rng.uniform(0.0, horizon_s,
                               size=n_jobs - times.size)]))
    mu, sigma = _DURATION[shape]
    durations = rng.lognormal(mu, sigma, size=n_jobs)
    sizes, weights = zip(*_GPU_MIX[shape])
    gpus = rng.choice(sizes, size=n_jobs,
                      p=np.asarray(weights) / sum(weights))
    # zipf-ish VC popularity; a few busy tenants, a long quiet tail
    vc_w = 1.0 / np.arange(1, n_vcs + 1)
    vcs = rng.choice(n_vcs, size=n_jobs, p=vc_w / vc_w.sum())
    prio = rng.choice([0, 0, 0, 1, 2], size=n_jobs)
    return [TraceJob(job_id=f"job-{i:06d}", vc=f"vc{int(vcs[i])}",
                     submit_s=float(round(times[i], 3)),
                     duration_s=float(round(durations[i], 3)),
                     gpus=int(gpus[i]), priority=int(prio[i]))
            for i in range(n_jobs)]


def philly_trace(n_jobs: int, seed: int = 0, **kw) -> list[TraceJob]:
    return synthetic_trace(n_jobs, seed=seed, shape="philly", **kw)


def helios_trace(n_jobs: int, seed: int = 0, **kw) -> list[TraceJob]:
    return synthetic_trace(n_jobs, seed=seed, shape="helios", **kw)


# ---------------------------------------------------------------------------
# import / export
# ---------------------------------------------------------------------------


def save_trace(path: str, jobs: list[TraceJob]) -> None:
    """Write a trace as CSV (``.csv``) or JSONL (anything else)."""
    if path.endswith(".csv"):
        with open(path, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=TRACE_FIELDS)
            w.writeheader()
            for j in jobs:
                w.writerow(j.to_dict())
        return
    with open(path, "w") as fh:
        for j in jobs:
            fh.write(json.dumps(j.to_dict(), sort_keys=True) + "\n")


def load_trace(path: str) -> list[TraceJob]:
    """Read a CSV/JSONL trace written by :func:`save_trace` (or an
    external exporter using the same column names)."""
    rows: list[dict] = []
    if path.endswith(".csv"):
        with open(path, newline="") as fh:
            rows = list(csv.DictReader(fh))
    else:
        with open(path) as fh:
            rows = [json.loads(ln) for ln in fh if ln.strip()]
    jobs = []
    for i, r in enumerate(rows):
        missing = [f for f in ("vc", "gpus") if f not in r]
        if missing:
            raise ValueError(
                f"trace row {i} missing fields {missing}: {r}")
        jobs.append(TraceJob(
            job_id=str(r.get("job_id", f"job-{i:06d}")),
            vc=str(r["vc"]),
            submit_s=float(r.get("submit_s", i)),
            duration_s=float(r.get("duration_s", 0.0)),
            gpus=int(r["gpus"]),
            priority=int(r.get("priority", 0))))
    return jobs


# ---------------------------------------------------------------------------
# trace -> store
# ---------------------------------------------------------------------------


def store_from_trace(jobs: list[TraceJob],
                     capacity_frac: float = 0.25,
                     total_gpus: Optional[int] = None,
                     borrowing: bool = True):
    """Materialize a trace as a contended store snapshot.

    Each VC becomes a ClusterQueue under one shared cohort with a
    ``gpu``-flavored quota sized from its demand share; every job
    becomes a PENDING workload (creation_time = submit_s). Cluster
    capacity defaults to ``capacity_frac`` of total traced demand, so
    the base sweep is already contended — the regime where preemption
    and borrowing decisions actually differ. Returns the Store.
    """
    from kueue_oss_tpu_torch.api.types import (
        ClusterQueue,
        Cohort,
        FlavorQuotas,
        LocalQueue,
        PodSet,
        PreemptionPolicy,
        PreemptionPolicyValue,
        ResourceFlavor,
        ResourceGroup,
        ResourceQuota,
        Workload,
    )
    from kueue_oss_tpu_torch.core.store import Store

    if not jobs:
        raise ValueError("empty trace")
    demand: dict[str, int] = {}
    for j in jobs:
        demand[j.vc] = demand.get(j.vc, 0) + j.gpus
    total_demand = sum(demand.values())
    if total_gpus is None:
        total_gpus = max(len(demand),
                         int(round(total_demand * capacity_frac)))
    store = Store()
    store.upsert_resource_flavor(ResourceFlavor(name="gpu"))
    store.upsert_cohort(Cohort(name="cluster"))
    for vc in sorted(demand):
        nominal = max(1, int(round(
            total_gpus * demand[vc] / total_demand)))
        store.upsert_cluster_queue(ClusterQueue(
            name=vc, cohort="cluster",
            preemption=PreemptionPolicy(
                within_cluster_queue=(
                    PreemptionPolicyValue.LOWER_PRIORITY),
                reclaim_within_cohort=PreemptionPolicyValue.ANY),
            resource_groups=[ResourceGroup(
                covered_resources=["gpu"],
                flavors=[FlavorQuotas(name="gpu", resources=[
                    ResourceQuota(
                        name="gpu", nominal=nominal,
                        borrowing_limit=None if borrowing else 0),
                ])])]))
        store.upsert_local_queue(
            LocalQueue(name=f"lq-{vc}", cluster_queue=vc))
    for i, j in enumerate(sorted(jobs, key=lambda j: (j.submit_s,
                                                      j.job_id))):
        store.add_workload(Workload(
            name=j.job_id, queue_name=f"lq-{j.vc}",
            priority=j.priority, creation_time=j.submit_s,
            uid=i + 1,
            podsets=[PodSet(name="main", count=1,
                            requests={"gpu": j.gpus})]))
    return store


# ---------------------------------------------------------------------------
# the breaking-point ladder
# ---------------------------------------------------------------------------


def load_ladder(store, factors=(1.0, 2.0, 4.0, 8.0), queues=None,
                config=None, full: Optional[bool] = None,
                parity: int = 0, slo_admission_rate: float = 0.9,
                starvation_age_s: float = 3600.0, device="cuda") -> dict:
    """Answer "what breaks first as load doubles?" for a store.

    Sweeps ``arrival_scale`` over ``factors`` (one batched what-if
    dispatch; FULL-kernel capable via ``full``) and scans the rungs in
    order for three breaking points:

    - **first_slo_burn** — admission rate below ``slo_admission_rate``;
    - **first_starvation_breach** — pending-age p95 above
      ``starvation_age_s``;
    - **first_borrow_ceiling** — any CQ pinned at its borrowing
      ceiling (own borrowingLimit or exhausted cohort pool).

    Returns a dict with the per-rung KPI rows, the three breaking
    points (factor or None), ``what_breaks_first``, and the underlying
    WhatIfReport (for parity/tier forensics). The sweep runs on
    ``device``."""
    from kueue_oss_tpu_torch.sim.engine import WhatIfEngine
    from kueue_oss_tpu_torch.sim.scenario import ScenarioSpec

    factors = sorted(float(f) for f in factors)
    if not factors or factors[0] <= 0:
        raise ValueError("factors must be positive")
    specs = [ScenarioSpec(name=f"load-x{f:g}", arrival_scale=f)
             for f in factors]
    report = WhatIfEngine(store, queues=queues, config=config,
                          device=device).run(specs, parity=parity, full=full)
    ladder = []
    first = {"slo_burn": None, "starvation_breach": None,
             "borrow_ceiling": None}
    for f, row in zip(factors, report.scenarios):
        breaches = {
            "slo_burn": row["admission_rate"] < slo_admission_rate,
            "starvation_breach": (row["starvation_age_p95"]
                                  > starvation_age_s),
            "borrow_ceiling": row["cqs_at_borrow_ceiling"] > 0,
        }
        for k, hit in breaches.items():
            if hit and first[k] is None:
                first[k] = f
        ladder.append({"factor": f, "breaches": breaches, **row})
    hit_first = [k for k, f in first.items() if f is not None]
    what_breaks_first = (min(hit_first, key=lambda k: first[k])
                         if hit_first else None)
    return {
        "ladder": ladder,
        "first_slo_burn": first["slo_burn"],
        "first_starvation_breach": first["starvation_breach"],
        "first_borrow_ceiling": first["borrow_ceiling"],
        "what_breaks_first": what_breaks_first,
        "slo_admission_rate": slo_admission_rate,
        "starvation_age_s": starvation_age_s,
        "report": report,
    }

"""The streaming runs of chip_smoke.py's phase 15, for either package.

Phase 15 drives bench.py's streaming arm (``scenarios.streaming_store``
and ``scenarios.streaming_ticks``) through ``Scheduler(solver="auto",
solver_min_backlog=0, streaming=...)``: the ``single`` fleet at 128
arrivals a tick with three twins (``micro``: streaming with the device
micro-solve; ``host``: streaming with ``micro_solve = False``, the host
walk; ``batch``: no streaming) and the ``wide`` fleet at 16 arrivals a
tick with two (``stream``, ``batch``). Each run records the
timestamped digest and the committed-store digest (no timestamps: the
stream and batch twins must agree on it) at every full-drain boundary,
the workloads holding
quota, the streamed admissions, the virtual time-to-admit p50 / p95,
the entries the micro-solves took and the micro-drains that ran one.

The JAX side is the JAX ``Scheduler`` over a JAX ``SolverEngine`` built
with ``mesh_mode="off"`` and ``scheduler=`` that scheduler, passed in as
the engine instance; the port side is the port's ``Scheduler(solver=
"auto", device=...)``. chip_smoke.py keeps its own copy of
``timed_store_digest`` (port types only); the tests hold the two copies
to each other.

Run as a script, ``JAX_PLATFORMS=cpu python tests/torch_streaming_pins.py``,
it prints the JAX package's records at full size in the form
chip_smoke.py pins them (several minutes on the CPU: the batch twins'
full drains of 12,800 workloads dominate).
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_scheduler_pins as P  # noqa: E402
from kueue_oss_tpu_torch import scenarios  # noqa: E402

#: phase 15's runs: (fleet, arrivals a tick, ticks, twins)
STREAMING_RUNS = {
    "single": (128, 100, ("micro", "host", "batch")),
    "wide": (16, 400, ("stream", "batch")),
}


def timed_store_digest(store) -> str:
    """``committed_store_digest`` plus each workload's QuotaReserved
    transition time: streaming changes when an admission lands, so the
    digest must see it; works on either package's store."""
    times = []
    for key in sorted(store.workloads):
        c = store.workloads[key].status.conditions.get("QuotaReserved")
        times.append(None if c is None else [c.status,
                                             c.last_transition_time])
    return hashlib.sha256(json.dumps(
        [P.committed_store_digest(store), times],
        separators=(",", ":")).encode()).hexdigest()


def queue_state(queues) -> dict:
    """Each ClusterQueue's heap and parked keys."""
    return {name: (sorted(q._in_heap), sorted(q.inadmissible))
            for name, q in sorted(queues.queues.items())}


def _jax_counts() -> dict:
    from kueue_oss_tpu import metrics

    def labelled(counter):
        return {k[0]: int(v) for k, v in sorted(counter.collect().items())
                if v}

    return {
        "stream_admitted_total": int(metrics.stream_admitted_total.total()),
        "stream_demotions_total": labelled(metrics.stream_demotions_total),
        "stream_microdrains_total": labelled(
            metrics.stream_microdrains_total),
        "stream_eligible_fraction": float(
            metrics.stream_eligible_fraction.value()),
        "stream_spec_solves_total": int(
            metrics.stream_spec_solves_total.total()),
    }


def _port_counts(sched) -> dict:
    sa = sched._streaming_instance
    if sa is None:
        return {"stream_admitted_total": 0, "stream_demotions_total": {},
                "stream_microdrains_total": {},
                "stream_eligible_fraction": 0.0,
                "stream_spec_solves_total": 0}
    c = sa.counts
    return {
        "stream_admitted_total": c["stream_admitted_total"],
        "stream_demotions_total": {
            k: v for k, v in sorted(c["stream_demotions_total"].items())
            if v},
        "stream_microdrains_total": {
            k: v for k, v in sorted(c["stream_microdrains_total"].items())
            if v},
        "stream_eligible_fraction": float(c["stream_eligible_fraction"]),
        "stream_spec_solves_total": c["stream_spec_solves_total"],
    }


def jax_package():
    """The JAX package: ``make(store, streaming)`` -> (queues, sched,
    engine); ``counts(sched)`` reads its process-wide stream metrics,
    which ``reset()`` zeroes."""
    from kueue_oss_tpu import metrics
    from kueue_oss_tpu.api import types
    from kueue_oss_tpu.core.queue_manager import QueueManager
    from kueue_oss_tpu.core.store import Store
    from kueue_oss_tpu.scheduler.scheduler import Scheduler
    from kueue_oss_tpu.solver.engine import SolverEngine

    def make(store, streaming):
        queues = QueueManager(store)
        sched = Scheduler(store, queues, solver_min_backlog=0,
                          streaming=streaming)
        sched.solver = SolverEngine(store, queues, scheduler=sched,
                                    mesh_mode="off")
        # the relaxed arm routes by wall clock: pinned off
        sched.solver.relax_enabled = False
        return queues, sched, sched._solver_engine()

    return SimpleNamespace(name="jax", types=types, Store=Store,
                           make=make, counts=lambda sched: _jax_counts(),
                           reset=metrics.reset_all)


def port_package(device: str = "cpu"):
    """The port on ``device``, with the same interface."""
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler

    def make(store, streaming):
        queues = QueueManager(store)
        sched = Scheduler(store, queues, solver="auto",
                          solver_min_backlog=0, streaming=streaming,
                          device=device)
        sched._solver_engine().relax_enabled = False
        return queues, sched, sched._solver_engine()

    return SimpleNamespace(name="port", types=types, Store=Store,
                           make=make, counts=_port_counts,
                           reset=lambda: None)


def run_ticks(pkg, profile: str, twin: str, *, per_tick: int,
              ticks: int, solve_every: int = scenarios.STREAM_SOLVE_EVERY
              ) -> dict:
    """One twin of the streaming arm (``micro``, ``host``, ``stream`` or
    ``batch``) on a fresh fleet; returns its record."""
    pkg.reset()
    store = scenarios.streaming_store(pkg.types, pkg.Store, profile=profile)
    stream = twin != "batch"
    _queues, sched, _engine = pkg.make(store, stream)
    if twin == "host":
        sched._streaming_admitter().micro_solve = False
    boundaries, committed = [], []
    micro_entries = micro_solves = 0
    for kind, _tick, res in scenarios.streaming_ticks(
            pkg.types, store, sched, ticks=ticks,
            per_tick=per_tick, stream=stream, solve_every=solve_every):
        if kind == "micro":
            micro_entries += res.micro_batch
            micro_solves += res.micro_batch > 0
        else:
            boundaries.append(timed_store_digest(store))
            committed.append(P.committed_store_digest(store))
    counts = pkg.counts(sched)
    return {"workloads": len(store.workloads),
            **scenarios.time_to_admit_ms(store),
            "stream_admitted": counts["stream_admitted_total"],
            "micro_entries": micro_entries, "micro_solves": micro_solves,
            "boundaries": boundaries, "committed": committed}


def main() -> None:
    pkg = jax_package()
    out = {}
    for profile, (per_tick, ticks, twins) in STREAMING_RUNS.items():
        out[profile] = {twin: run_ticks(pkg, profile, twin,
                                        per_tick=per_tick, ticks=ticks)
                        for twin in twins}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

"""Shared helpers of the observability parity tests: reset either
package's process-wide observability state, run a scenario, and read
back what the recorder, the ledger, the metrics registry and device
telemetry hold, in forms that two packages can be compared by.

Run as a script, it prints chip_smoke.py's phase-23 pins: the JAX
package's journal digest, per-kind counts, ledger rows, deterministic
metric lines and devtel compile events for the TAS store of phase 12
at 1,500 workloads through ``Scheduler(solver="auto")`` (~1 min):

    JAX_PLATFORMS=cpu python tests/torch_obs_pins.py

The byte counts of the ledger rows and of devtel's transfer ledger are
the JAX package's own: the port ships int64 row indices to
``index_copy_`` where JAX ships int32 ones (``solver/delta.py``), so a
delta epoch's ``donated_update_bytes`` differs by 4 bytes per dirty
row. chip_smoke.py checks the port's bytes against the port's own
per-drain device deltas instead.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import re

#: metric families whose samples are wall-clock readings (or derived
#: from them): only a histogram's count is deterministic, and these
#: gauges and counters are left out altogether
TIMED_HISTOGRAMS = (
    "kueue_admission_attempt_duration_seconds",
    "kueue_tpu_solver_cycle_duration_seconds",
    "kueue_tpu_whatif_duration_seconds",
    "kueue_tpu_solver_compile_seconds",
    "kueue_tpu_solver_farm_grant_wait_seconds",
    "kueue_multikueue_dispatch_score_ms",
    "kueue_checkpoint_duration_seconds",
)
TIMED_SAMPLES = (
    "kueue_cycle_phase_regression",
    "kueue_cycle_phase_regression_ratio",
    "kueue_tpu_solver_farm_wall_seconds_total",
    # device-specific (the CUDA allocator) and the index-dtype note above
    "kueue_tpu_solver_hbm_bytes_in_use",
    "kueue_tpu_solver_hbm_resident_bytes",
    "kueue_tpu_solver_transfer_bytes_total",
)


def modules(pkg: str):
    """(obs, metrics, devtel, replay) of ``kueue_oss_tpu`` or
    ``kueue_oss_tpu_torch``."""
    return (importlib.import_module(f"{pkg}.obs"),
            importlib.import_module(f"{pkg}.metrics"),
            importlib.import_module(f"{pkg}.obs.devtel"),
            importlib.import_module(f"{pkg}.sim.replay"))


def reset(pkg: str) -> None:
    """Back to the process defaults: recorder, ledger and SLO engine on
    and empty, metrics cleared, devtel off."""
    obs, metrics, devtel, _ = modules(pkg)
    obs.recorder.clear()
    obs.recorder.enabled = True
    obs.cycle_ledger.clear()
    obs.cycle_ledger.enabled = True
    obs.slo_engine.reset()
    obs.slo_engine.enabled = True
    obs.phase_regression.reset()
    devtel.collector.reset()
    metrics.reset_all()


def journal(pkg: str) -> list[tuple]:
    """(kind, workload, cycle, cluster_queue, path, reason_slug,
    breaker) of every recorded event, in order."""
    obs = modules(pkg)[0]
    return [(ev.kind, ev.workload, ev.cycle, ev.cluster_queue, ev.path,
             ev.reason_slug, ev.breaker) for ev in obs.recorder.events()]


def journal_full(pkg: str) -> list[dict]:
    """Every event's dict without its seq and wall timestamp."""
    obs = modules(pkg)[0]
    out = []
    for ev in obs.recorder.events():
        d = ev.to_dict()
        d.pop("seq")
        d.pop("ts")
        out.append(d)
    return out


def journal_digest(rows: list[tuple]) -> str:
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def kind_counts(rows: list[tuple]) -> dict:
    out: dict = {}
    for r in rows:
        out[r[0]] = out.get(r[0], 0) + 1
    return dict(sorted(out.items()))


def ledger_rows(pkg: str, with_bytes: bool = True) -> list[dict]:
    """Every ledger row's deterministic fields: kind, cycle, breaker,
    counts, solver arm, frame kind / bytes / reason, session stats,
    phase names, and the device deltas (their counts and, with
    ``with_bytes``, their bytes)."""
    obs = modules(pkg)[0]
    out = []
    for r in obs.cycle_ledger.rows():
        d = r.to_dict()
        for k in ("seq", "ts", "durationS", "grantWaitMs"):
            d.pop(k, None)
        d["phases"] = sorted(d.get("phases", {}))
        dev = dict(d.pop("device", {}) or {})
        dev.pop("compile_events", None)
        for k in ("hbm_resident_bytes", "hbm_bytes_in_use"):
            dev.pop(k, None)
        if not with_bytes:
            dev = {k: v for k, v in dev.items() if not k.endswith("bytes")}
        if dev:
            d["device"] = dev
        out.append(d)
    return out


def _family(line: str) -> str:
    return re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", line).group(0)


def render_lines(pkg: str) -> list[str]:
    """The registry's exposition, cut to its deterministic samples: no
    HELP / TYPE lines, a timed histogram's count only, no timed gauge
    or counter."""
    metrics = modules(pkg)[1]
    out = []
    for line in metrics.registry.render().splitlines():
        if not line or line.startswith("#"):
            continue
        name = _family(line)
        if any(name == f or name.startswith(f + "_")
               for f in TIMED_HISTOGRAMS):
            if not name.endswith("_count"):
                continue
        elif name in TIMED_SAMPLES:
            continue
        out.append(line)
    return out


def compile_events(pkg: str) -> list[tuple]:
    """devtel's compile events (kernel, arm, bucket) in order: those the
    solver ledger rows took, then any not yet taken."""
    obs, _, devtel, _ = modules(pkg)
    events = []
    for r in obs.cycle_ledger.rows():
        events.extend((r.device or {}).get("compile_events", []))
    events.extend(devtel.collector.compiles.drain_events())
    return [(e["kernel"], e["arm"], e["bucket"]) for e in events]


def resident_counts(engine) -> dict:
    """Full uploads and delta updates of each resident device state."""
    return {kind: [int(dev.full_uploads), int(dev.delta_updates)]
            for kind, dev in sorted(engine._device_states.items())}


def devtel_on(pkg: str, **kw) -> None:
    """Turn device telemetry on with its default sub-switches."""
    devtel = modules(pkg)[2]
    c = devtel.collector
    c.enabled = True
    for k, v in kw.items():
        setattr(c, k, v)


def _lean_store(types, store_cls, n_cqs: int = 4, quota: int = 8):
    """Four one-flavor ClusterQueues (the routing tests' store)."""
    store = store_cls()
    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    for i in range(n_cqs):
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{i}",
            resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[types.FlavorQuotas(name="f", resources=[
                    types.ResourceQuota(name="cpu", nominal=quota)])])]))
        store.upsert_local_queue(types.LocalQueue(
            name=f"lq{i}", cluster_queue=f"cq{i}"))
    return store


def _flood(types, store, n: int, start: int = 0) -> None:
    for i in range(start, start + n):
        store.add_workload(types.Workload(
            name=f"w{i}", queue_name=f"lq{i % 4}", uid=i + 1,
            creation_time=float(i),
            podsets=[types.PodSet(name="main", count=1,
                                  requests={"cpu": 1})]))


def run_lean(package, *, tracer=None, prof=None) -> None:
    """A lean flood drained on the device, finishes, a second flood,
    then finishes and a trickle the host cycles take: drains with sync
    and delta frames, host cycles, finished counters."""
    types, store_cls, make, _ = package
    store = _lean_store(types, store_cls)
    sched, _ = make(store, True, solver_min_backlog=16)
    if tracer is not None:
        prof.attach_to_scheduler(sched, tracer)
    _flood(types, store, 64)
    sched.run_until_quiet(now=0.0)
    held = sorted(k for k, w in store.workloads.items()
                  if w.is_quota_reserved and not w.is_finished)
    for k in held[:12]:
        sched.finish_workload(k, now=1.0)
    _flood(types, store, 48, start=100)
    sched.run_until_quiet(now=2.0)
    for k in held[12:20]:
        sched.finish_workload(k, now=3.0)
    _flood(types, store, 3, start=200)  # a trickle: host cycles
    sched.run_until_quiet(now=3.0)
    return sched


def _run_storm(package, solver: bool):
    from kueue_oss_tpu_torch import scenarios
    import torch_scheduler_pins as P

    P.run_waves(package, scenarios.baseline_preempt_store, solver=solver,
                scale=0.1)


def run_tas(package, **store_kw):
    """The TAS drain store through ``Scheduler(solver="auto")`` (the
    shape of chip_smoke.py's phase 12). Returns (cycles, engine)."""
    from kueue_oss_tpu_torch import scenarios

    types, store_cls, make, _ = package
    store = scenarios.tas_drain_store(types, store_cls, **store_kw)
    sched, drains = make(store, True)
    return sched.run_until_quiet(now=0.0, tick=0.001), drains.engine


#: the CPU parity scenarios: name -> runner(package)
CASES = {
    "lean": run_lean,
    "tas": lambda package: run_tas(package, n_racks=4, n_hosts=8,
                                   n_cohorts=2, n_cqs=3, n_workloads=600),
    "storm_host": lambda package: _run_storm(package, False),
    "storm_full": lambda package: _run_storm(package, True),
}

_captured: dict = {}


def capture(case: str, pkg: str) -> dict:
    """Run ``case`` on ``pkg`` with devtel on and read back every
    surface (memoized per process: the parity tests share the runs)."""
    key = (case, pkg)
    if key not in _captured:
        import torch_scheduler_pins as P

        package = (P.jax_package() if pkg == "kueue_oss_tpu"
                   else P.port_package("cpu"))
        reset(pkg)
        devtel_on(pkg)
        CASES[case](package)
        obs, _, devtel, replay = modules(pkg)
        events = obs.recorder.events()
        _captured[key] = {
            "journal": journal(pkg),
            "journal_full": journal_full(pkg),
            "explain": {k: [_strip(e.to_dict()) for e in
                            obs.recorder.explain(k)]
                        for k in sorted({e.workload for e in events})},
            "decisions": [{"cycle": d["cycle"],
                           "events": [_strip(e) for e in d["events"]]}
                          for d in obs.recorder.decisions(last_cycles=8)],
            "kinds_per_cycle": replay.kind_counts_per_cycle(events),
            "ledger": ledger_rows(pkg),
            "render": render_lines(pkg),
            "compiles": compile_events(pkg),
            "transfer": dict(devtel.collector.transfer_bytes),
            "slo": obs.slo_engine.evaluate(),
            "jsonl": obs.recorder.to_jsonl(),
        }
    return _captured[key]


def _strip(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in ("seq", "ts")}


def reference_pins(n_workloads: int = 1500) -> dict:
    """chip_smoke.py's ``OBS_REFERENCE``: the JAX package's run of phase
    12's store with devtel on, as the journal's digest and kind counts,
    the ledger rows, the deterministic metric lines' count and digest,
    the compile events and the resident states' upload / update
    counts."""
    import torch_scheduler_pins as P

    pkg = "kueue_oss_tpu"
    reset(pkg)
    devtel_on(pkg)
    cycles, engine = run_tas(P.jax_package(), n_workloads=n_workloads)
    rows = journal(pkg)
    render = render_lines(pkg)
    return {"events": len(rows), "digest": journal_digest(rows),
            "kinds": kind_counts(rows), "cycles": cycles,
            "ledger": ledger_rows(pkg), "resident": resident_counts(engine),
            "render_lines": len(render),
            "render_digest": hashlib.sha256(
                "\n".join(render).encode()).hexdigest(),
            "compiles": [list(c) for c in compile_events(pkg)]}


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    print(json.dumps(reference_pins(), indent=1))

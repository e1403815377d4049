"""Where the drains' time goes on the card.

    python3 -m kueue_oss_tpu_torch.profile_drain [--churn]

Three scenarios by default:

- ``tas_drain``: the lean TAS drain (``scenarios.tas_drain_store``) at
  the full tree and ClusterQueue widths but 1,500 workloads instead of
  15,000: the profiler records every eager op and kernel, and at the
  full backlog (~1.5 M ops) its own overhead outruns a chip call. The
  cut keeps what a round is (30 ClusterQueue heads, one admission scan
  step each, the same 640-leaf tree) and shortens the number of rounds;
- ``storm``: the FULL drain of the Kueue baseline preemption storm
  (``scenarios.baseline_preempt_store``) at full size, both waves
  (28 rounds in all), measured over the two drains together;
- ``fair_wave2``: the fair-sharing FULL drain of the fair reclamation
  storm's second wave (``scenarios.fair_reclaim_store`` at full size,
  7 rounds, 200 evictions), measured alone: its first wave is drained
  before the measurement starts.

With ``--churn``, one scenario instead:

- ``storm_churn``: the first measured cycle (cycle 3) of the baseline
  storm under the finish-and-arrive churn
  (``scenarios.storm_churn_drains``: both waves, two warm-up cycles of
  30 finishes and 75 arrivals) with delta sessions on (the engine's
  default), measured alone: the earlier drains run before the
  measurement starts.

Each scenario runs three times on the CUDA device: once plain, for the
wall time and its phases; once under ``torch.profiler``, for the device
time by kernel name; once under ``torch.cuda.set_sync_debug_mode
("warn")``, counting host synchronisations by source line. Only the
measured drains run inside the profiler and the sync counting. Prints one
JSON object: the card (name, power limit) and per scenario the plain
run's phases, the device busy seconds, the device idle share of the
plain run's wall (1 - busy / wall), the top kernels by device time, the
synchronisation counts and, for the FULL drain, its own counters
(``DrainResult.full_stats``). Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

WORKLOADS = 1500
TOP_KERNELS = 12


def _tas_drain(around=contextlib.nullcontext, n_workloads: int = WORKLOADS):
    """The lean TAS drain, inside ``around()``; returns ([result], wall
    seconds)."""
    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import tas_drain_store
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    store = tas_drain_store(types, Store, n_workloads=n_workloads)
    engine = SolverEngine(store, QueueManager(store))
    torch.cuda.synchronize()
    with around():
        t0 = time.monotonic()
        result = engine.drain(now=0.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return [result], wall


def _storm_drain(around=contextlib.nullcontext):
    """Both waves of the baseline storm, inside ``around()``; returns
    ([result per wave], the two drains' wall seconds summed)."""
    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import baseline_preempt_store
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    store, wave1, wave2 = baseline_preempt_store(types, Store)
    engine = SolverEngine(store, QueueManager(store))
    results, wall = [], 0.0
    with around():
        for now, wave in ((100.0, wave1), (200.0, wave2)):
            for wl in wave:
                store.add_workload(wl)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            results.append(engine.drain(now=now))
            torch.cuda.synchronize()
            wall += time.monotonic() - t0
    return results, wall


def _fair_wave2(around=contextlib.nullcontext):
    """The fair storm's second wave, inside ``around()``, after its
    first wave; returns ([result], wall seconds)."""
    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import fair_reclaim_store
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    store, wave1, wave2 = fair_reclaim_store(types, Store)
    engine = SolverEngine(store, QueueManager(store),
                          enable_fair_sharing=True)
    for wl in wave1:
        store.add_workload(wl)
    engine.drain(now=100.0)
    for wl in wave2:
        store.add_workload(wl)
    torch.cuda.synchronize()
    with around():
        t0 = time.monotonic()
        result = engine.drain(now=200.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return [result], wall


def _churn_cycle(around=contextlib.nullcontext):
    """The storm's first measured churn cycle, inside ``around()``,
    after both waves and the warm-up cycles; returns ([result], wall
    seconds)."""
    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.eviction import finish_workload
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import (
        StormChurn,
        baseline_preempt_store,
        storm_churn_drains,
    )
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    store, wave1, wave2 = baseline_preempt_store(types, Store)
    queues = QueueManager(store)
    engine = SolverEngine(store, queues)
    measured = f"cycle{StormChurn.WARM_CYCLES + 1}"
    for label, now in storm_churn_drains(
            types, store, wave1, wave2,
            lambda key, t: finish_workload(store, queues, key, t)):
        if label != measured:
            engine.drain(now=now)
            continue
        torch.cuda.synchronize()
        with around():
            t0 = time.monotonic()
            result = engine.drain(now=now)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        return [result], wall
    raise AssertionError(f"no {measured} in the churn sequence")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_drain: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    _tas_drain(n_workloads=200)  # warm-up: build, CUDA context, allocator
    if "--churn" in sys.argv[1:]:
        print(json.dumps({"card": smi,
                          "storm_churn": _profile(_churn_cycle)}))
        return 0
    print(json.dumps({"card": smi,
                      "tas_drain": _profile(_tas_drain),
                      "storm": _profile(_storm_drain),
                      "fair_wave2": _profile(_fair_wave2)}))
    return 0


@contextlib.contextmanager
def _sync_warnings():
    """Warn on every host synchronisation inside the block."""
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _profile(drain) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    plain, wall = drain()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    profiled, profiled_wall = drain(lambda: prof)
    # device-side events only (kernels, memcpy/memset): the CPU ops that
    # launched them carry the same time again as children
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda]
    kernels = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    if not kernels:
        raise RuntimeError("the profiler recorded no device time; time "
                           "the drain with CUDA events instead")
    busy_s = sum(r[2] for r in kernels) / 1e6

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        drain(_sync_warnings)
    syncs = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message))
    full = [r.full_stats for r in plain if r.full_stats is not None]
    return {
        "admitted": [r.admitted for r in plain],
        "evicted": [r.evicted for r in plain],
        "rounds": [r.rounds for r in plain],
        "same_plan_under_profiler": ([r.admitted_keys for r in profiled]
                                     == [r.admitted_keys for r in plain]),
        "drain_s": wall,
        "phases_s": [r.phases for r in plain],
        "profiled_drain_s": profiled_wall,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall,
        "device_kernels": sum(r[1] for r in kernels),
        "top_kernels": [{"name": k, "count": c, "device_s": us / 1e6}
                        for k, c, us in kernels[:TOP_KERNELS]],
        "host_syncs": sum(syncs.values()),
        "host_syncs_by_line": dict(syncs.most_common()),
        "full_stats": [vars(st) for st in full],
        "frames": [None if r.frame is None else
                   ("delta" if r.frame.delta is not None
                    else r.frame.full_reason) for r in plain],
        "device_updates": [r.device for r in plain],
    }


if __name__ == "__main__":
    sys.exit(main())

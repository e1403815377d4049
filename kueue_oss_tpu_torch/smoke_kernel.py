"""Quick host-vs-drain parity smoke on a shrunken large-scale shape.

The port's counterpart of ``tools/smoke_kernel.py``: Kueue's
large-scale generator config with preemption, cut to ``n_cohorts`` x
``cqs_per_cohort`` ClusterQueues and each class's count divided by
``div``, drained once by ``SolverEngine`` on the device (the FULL
drain) and, on a second copy of the store, by host cycles
(``Scheduler.run_until_quiet``); the sets of workloads holding quota
must be equal.

Usage: python -m kueue_oss_tpu_torch.smoke_kernel [n_cohorts]
[cqs_per_cohort] [div] [--device cuda|cpu]. The default device is the
card; without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import sys
import time


def _store(n_cohorts: int, cqs: int, div: int):
    from kueue_oss_tpu_torch.perf.generator import GeneratorConfig, generate

    config = GeneratorConfig.large_scale(preemption=True)
    config.n_cohorts, config.cqs_per_cohort = n_cohorts, cqs
    for wc in config.classes:
        wc.count = max(1, wc.count // div)
    store, schedule = generate(config)
    for g in schedule:
        store.add_workload(g.workload)
    return store, len(schedule)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_cohorts", nargs="?", type=int, default=1)
    ap.add_argument("cqs_per_cohort", nargs="?", type=int, default=2)
    ap.add_argument("div", nargs="?", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.device import resolve_device
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"smoke_kernel: {e}", file=sys.stderr)
        return 1
    t0 = time.time()
    store, n = _store(args.n_cohorts, args.cqs_per_cohort, args.div)
    engine = SolverEngine(store, QueueManager(store), device=device)
    print(f"setup {time.time() - t0:.1f}s "
          f"(W={n} C={args.n_cohorts * args.cqs_per_cohort}, "
          f"device {device})", flush=True)
    t0 = time.time()
    r = engine.drain(now=0.0)
    print(f"kernel admitted={r.admitted} evicted={r.evicted} "
          f"rounds={r.rounds} solve={r.phases.get('solve', 0.0):.2f}s "
          f"total={time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    store2, _ = _store(args.n_cohorts, args.cqs_per_cohort, args.div)
    Scheduler(store2, QueueManager(store2), device=device).run_until_quiet(
        now=0.0, max_cycles=20000, tick=1.0)
    adm_h = {k for k, w in store2.workloads.items() if w.is_quota_reserved}
    adm_k = {k for k, w in store.workloads.items() if w.is_quota_reserved}
    print(f"host admitted={len(adm_h)} ({time.time() - t0:.1f}s) "
          f"agree={len(adm_h & adm_k)} union={len(adm_h | adm_k)}",
          flush=True)
    if adm_h != adm_k:
        print("MISMATCH only-host:", sorted(adm_h - adm_k)[:6])
        print("MISMATCH only-kernel:", sorted(adm_k - adm_h)[:6])
        return 1
    print("PARITY OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

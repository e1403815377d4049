#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (kueue_oss_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure propagates (nonzero exit, no result line):

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: compile every CUDA kernel of the drain path from the sources
   in the checkout (nvcc, at first use) and report the build seconds;
3. kernel vs plain: every kernel against its plain PyTorch version on
   the card, exact integer equality, on the main-path shapes and on
   random, all-zero-request, negative-capacity and leader cases; then
   CUDA-event times of kernel and plain version at the main-path shape;
4. main path: the full-size TAS drain (640 nodes, 30 ClusterQueues,
   15,000 workloads; the reference Kueue TAS performance config) built
   with the port's own types and drained by ``SolverEngine(store,
   queues).drain()`` on the card, with the launch counts reset just
   before the drain and read just after. The plan is checked against
   the JAX reference plan (admitted/rounds/parked counts and the plan
   digest) and against independent capacity and quota checks.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the JSON kernel report.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

#: the JAX package's plan on this store (102 admitted, 549 rounds)
REFERENCE = {"admitted": 102, "rounds": 549, "evicted": 0,
             "parked": 14898,
             "digest": "22ede1e7cac0f0ae5e34d56ef0205e204e1ee208cd35ba8c"
                       "b2fae3232b409bfc"}
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor fp32 ops/s
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def _time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _leaf_inputs(rng, D, R, lo, hi, req_hi, has_leader, device):
    import torch

    cap = torch.as_tensor(rng.integers(lo, hi, size=(D, R)),
                          dtype=torch.int32, device=device)
    per_pod = torch.as_tensor(rng.integers(0, req_hi, size=R),
                              dtype=torch.int32, device=device)
    leader = torch.as_tensor(rng.integers(0, req_hi, size=R),
                             dtype=torch.int32, device=device)
    flag = torch.tensor(has_leader, device=device)
    return cap, per_pod, leader, flag


def check_leaf_states(device) -> dict:
    """Phase 3 for ``leaf_states``: exact agreement on every case and
    the CUDA-event times at the main-path shape."""
    import numpy as np
    import torch

    from kueue_oss_tpu_torch.solver import cuda_tas

    rng = np.random.default_rng(640)
    cases = []
    # the drain's leaf tile: 640 hosts x (cpu, pods), and x cpu only
    for R in (2, 1):
        cap, pp, lead, flag = _leaf_inputs(rng, 640, R, 0, 111, 21,
                                           False, device)
        cases.append((f"main 640x{R}", cap, pp, lead, flag))
    for R in list(range(1, 10)) + [130]:
        D = int(rng.integers(1, 5001))
        cases.append((f"random {D}x{R}",) + _leaf_inputs(
            rng, D, R, 0, 200, 6, bool(rng.integers(0, 2)), device))
    cap, _, _, _ = _leaf_inputs(rng, 300, 3, 0, 200, 6, False, device)
    zero = torch.zeros(3, dtype=torch.int32, device=device)
    cases.append(("all-zero requests", cap, zero, zero,
                  torch.tensor(False, device=device)))
    for hl in (False, True):
        cases.append((f"negative capacity leader={hl}",) + _leaf_inputs(
            rng, 1000, 4, -300, 200, 7, hl, device))
        cases.append((f"leader={hl}",) + _leaf_inputs(
            rng, 777, 3, 0, 60, 9, hl, device))

    max_err = 0
    for name, cap, pp, lead, flag in cases:
        got = cuda_tas.leaf_states(cap, pp, lead, flag)
        want = cuda_tas.leaf_states_reference(cap, pp, lead, flag)
        torch.cuda.synchronize()
        for g, w, out in zip(got, want, ("st", "swl", "ls")):
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            max_err = max(max_err, err)
            if not torch.equal(g, w):
                raise AssertionError(
                    f"leaf_states {out} differs from the plain version on "
                    f"case {name!r} (max abs err {err})")
    print(f"[kernel] leaf_states == leaf_states_reference exactly on "
          f"{len(cases)} cases")

    name, cap, pp, lead, flag = cases[0]
    D, R = cap.shape
    ms = _time_ms(lambda: cuda_tas.leaf_states(cap, pp, lead, flag))
    plain_ms = _time_ms(
        lambda: cuda_tas.leaf_states_reference(cap, pp, lead, flag))
    nbytes = 4 * (D * R + 2 * R + 1 + 3 * D)
    nops = 8 * D * R  # compare, divide, min per element, twice
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return {"name": "leaf_states", "route": "cuda", "impl": "cuda",
            "source": "kueue_oss_tpu_torch/csrc/leaf_states.cu",
            "replaces": "kueue_oss_tpu/solver/pallas_tas.py:99",
            "max_abs_err": max_err, "exact": max_err == 0,
            "shape": [D, R], "ms": ms, "plain_ms": plain_ms,
            "kernel_us": ms * 1e3, "plain_us": plain_ms * 1e3,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def check_plan(store, queues, result) -> None:
    """The JAX reference plan plus independent capacity/quota checks."""
    from kueue_oss_tpu_torch.scenarios import plan_digest

    parked = sum(len(q.inadmissible) for q in queues.queues.values())
    got = {"admitted": result.admitted, "rounds": result.rounds,
           "evicted": result.evicted, "parked": parked,
           "digest": plan_digest(store, result.admitted_keys)}
    if got != REFERENCE:
        raise AssertionError(f"plan {got} != reference {REFERENCE}")

    node_cpu: dict[str, int] = {}
    cq_cpu: dict[str, int] = {}
    for key in result.admitted_keys:
        wl = store.workloads[key]
        adm = wl.status.admission
        psa = adm.podset_assignments[0]
        ta = psa.topology_assignment
        if ta is None or sum(d.count for d in ta.domains) != psa.count:
            raise AssertionError(f"{key}: topology assignment {ta} does "
                                 f"not place its {psa.count} pods")
        per_pod = wl.podsets[0].requests["cpu"]
        for d in ta.domains:
            node_cpu[d.values[-1]] = (node_cpu.get(d.values[-1], 0)
                                      + d.count * per_pod)
        cq_cpu[adm.cluster_queue] = (cq_cpu.get(adm.cluster_queue, 0)
                                     + psa.resource_usage["cpu"])
    for node, used in node_cpu.items():
        if used > store.nodes[node].allocatable["cpu"]:
            raise AssertionError(f"node {node} over capacity: {used}")
    cohort_cpu: dict[str, int] = {}
    cohort_nominal: dict[str, int] = {}
    for name, spec in store.cluster_queues.items():
        rq = spec.resource_groups[0].flavors[0].resources[0]
        used = cq_cpu.get(name, 0)
        if used > rq.nominal + rq.borrowing_limit:
            raise AssertionError(f"ClusterQueue {name} over its nominal "
                                 f"+ borrowing limit: {used}")
        cohort_cpu[spec.cohort] = cohort_cpu.get(spec.cohort, 0) + used
        cohort_nominal[spec.cohort] = (cohort_nominal.get(spec.cohort, 0)
                                       + rq.nominal)
    for cohort, used in cohort_cpu.items():
        if used > cohort_nominal[cohort]:
            raise AssertionError(f"cohort {cohort} over quota: {used}")
    print(f"[plan] matches the reference: {got}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs only on a CUDA device", file=sys.stderr)
        return 1

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {kind}; nvidia-smi: {smi}")

    # 2. build
    from kueue_oss_tpu_torch.solver import cuda_tas

    t0 = time.monotonic()
    lib = cuda_tas.build()
    print(f"[build] {lib.name} in {time.monotonic() - t0:.3f} s")

    # 3. kernel vs plain
    device = torch.device("cuda")
    report = check_leaf_states(device)

    # 4. main path at full size
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import tas_drain_store
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    t0 = time.monotonic()
    store = tas_drain_store(types, Store)
    queues = QueueManager(store)
    engine = SolverEngine(store, queues)
    setup_s = time.monotonic() - t0
    cuda_tas.leaf_states.launches = 0
    t0 = time.monotonic()
    result = engine.drain(now=0.0)
    torch.cuda.synchronize()
    drain_s = time.monotonic() - t0
    launches = cuda_tas.leaf_states.launches
    placed = sum(1 for k in result.admitted_keys
                 if store.workloads[k].status.admission
                 .podset_assignments[0].topology_assignment is not None)
    if launches == 0 or launches != placed:
        raise AssertionError(f"leaf_states launched {launches} times on "
                             f"the main path for {placed} placements")
    check_plan(store, queues, result)
    report["launches"] = launches

    timings = {"setup_s": setup_s, "drain_s": drain_s,
               **{f"{k}_s": v for k, v in result.phases.items()},
               "rounds": result.rounds, "admitted": result.admitted}
    print("[timings] " + json.dumps(timings))
    print(smi)
    print(json.dumps({"kernels": [report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (kueue_oss_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure propagates (nonzero exit, no result line):

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: compile every CUDA kernel from the sources in the checkout
   (one nvcc call, at first use) and report the build seconds and what
   ptxas said about each kernel (registers, shared memory, spills);
3. kernel vs plain: every kernel against its plain PyTorch version on
   the card, exact integer equality, with CUDA-event times of kernel and
   plain version at the main-path shape:
   - ``leaf_states`` on the main-path tiles and on random,
     all-zero-request, negative-capacity and leader cases;
   - ``tas_place_sequential`` on the drain-shaped batch, random 2/3/4
     level trees with slices, leaders, least-free and required /
     preferred / unconstrained requests, pre-rejected rows, M = 0, a
     tree above 48 KB of shared memory and one above 227 KB (global
     scratch); timed plain, kernel, kernel, plain;
4. stepwise placement: the full-size TAS drain placed by the plain
   sequential placer with the CUDA leaf pass (one leaf_states launch per
   podset, ~350 eager ops per podset around it), the placement path
   before tas_place_sequential, for its placement phase; its plan must
   be the reference plan too;
5. main path: the full-size TAS drain (640 nodes, 30 ClusterQueues,
   15,000 workloads; the reference Kueue TAS performance config) built
   with the port's own types and drained by ``SolverEngine(store,
   queues).drain()`` on the card (the engine's default: delta sessions
   on, so the drain's problem is the session's first sync, uploaded
   into the resident device state), with the launch counts reset just
   before the drain and read just after: one tas_place_sequential launch
   placing every TAS admission, no leaf_states launch. The plan is
   checked against the JAX reference plan (admitted/rounds/parked counts
   and the plan digest) and against independent capacity and quota
   checks; the batch phase 4 placed is replayed through the kernel and
   its plain version, which must agree exactly;
6. preemption storm: the reference Kueue scheduler baseline
   (test/performance/scheduler/configs/baseline/generator.yaml; 5
   cohorts x 6 ClusterQueues, 15,000 workloads, nothing cut) drained by
   the FULL path in two waves — every low-priority small workload, then
   the medium and large ones, which preempt 600 of them. Each wave's
   plan must equal the JAX reference plan (counts, rounds, digest) and
   pass independent checks: no ClusterQueue or cohort over quota, every
   victim either below a preemptor of its own ClusterQueue in priority
   or admitted in a borrowing ClusterQueue, and ``evicted_keys`` equal
   to the workloads whose QuotaReserved flipped to false. The FULL
   drain's lanes, loop iterations and host reads are printed;
7. TAS with preemption: the TAS store at 1,500 workloads with
   LowerPriority / Any preemption on every ClusterQueue, drained by the
   FULL path: the JAX reference plan, one tas_place_sequential launch
   placing every admission, no leaf_states launch;
8. fair storm: the baseline store under fair sharing
   (``SolverEngine(..., enable_fair_sharing=True)``), ClusterQueues 3-5
   of every cohort idle: the smalls of ClusterQueues 0 and 1 borrow the
   idle quota (3,500 workloads), then the medium and large workloads of
   ClusterQueue 2 (750) reclaim it, evicting 100 smalls as
   within-nominal reclamations and 100 by the fair strategy rules. Each
   wave's plan must equal the JAX reference plan (counts, rounds,
   digest, victims' reasons) and pass the quota checks; 32 search lanes
   per round (h_max = 32 under either search budget); the per-CQ
   dominant resource shares are printed after each wave;
9. admission fair sharing: the baseline smalls split over two
   LocalQueues per ClusterQueue, every ``-a`` queue charged 20 cpu at
   t = 0, drained at t = 60 s: the JAX reference plan (600 admitted in
   22 rounds, 570 from ``-b`` queues and 30 from ``-a`` queues: per
   ClusterQueue the ``-b`` queue admits until its entry penalties pass
   the ``-a`` queue's decayed charge of 17.4).

10. storm under churn, sessions on: the baseline store of phase 6 at
   full size, nothing cut, through one ``SolverEngine`` with delta
   sessions on (``scenarios.storm_churn_drains``): wave 1 at t = 100,
   wave 2 at t = 200, then the finish-and-arrive churn cycle of
   bench.py's delta scenario (two warm-up and eight measured cycles, at
   t = 201..210). ``churn`` is 75, but after wave 2 only 30 workloads
   hold quota, so each cycle finishes those 30 (the whole admitted set
   turns over; bench.py finishes about 0.5% of it) and submits 75 1-cpu
   arrivals, which never admit: 30 parked larges take the freed quota. Every drain's
   plan must equal the JAX engine's plan of the same sequence (sessions
   on, no mesh; pinned below: counts, rounds, plan digest, victims'
   reasons) and pass the quota and victim checks of phase 6; every
   frame's kind must be the one the JAX session emitted. After the last
   cycle every resident FULL tensor must equal a fresh upload of the
   session's last slotted problem, and the resident state's full
   uploads and delta updates must count the frames. A twin store run
   through the same sequence with ``use_sessions = False`` must reach
   the same decisions per drain (admitted set and flavors, evicted set
   and reasons) and reports the bytes it uploads per drain. Each drain
   prints its frame, dirty rows, update bytes and phase seconds for
   both engines.

Phases 6-9 pin the JAX engine's plans without delta sessions, so they
run the port's engine with ``use_sessions = False``; phase 10 pins the
plans with sessions on. Phases 8-10 run no TAS flavor: both kernels'
launch counts are set to 0 before each drain and must still be 0 after
it.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the JSON kernel report.
"""

from __future__ import annotations

import collections
import gc
import json
import subprocess
import sys
import time

#: the JAX package's plan on this store (102 admitted, 549 rounds)
REFERENCE = {"admitted": 102, "rounds": 549, "evicted": 0,
             "parked": 14898,
             "digest": "22ede1e7cac0f0ae5e34d56ef0205e204e1ee208cd35ba8c"
                       "b2fae3232b409bfc"}
#: the JAX package's plans of phase 6 (per wave) and phase 7: its
#: engine with ``mesh_mode="off"`` and without delta sessions
#: (KUEUE_SOLVER_SESSIONS=0), and so the port's engine with
#: ``use_sessions = False``; with sessions both engines re-lay a later
#: drain's rows into stable slots, which reorders wave 2's evicted keys
#: (the same set) and changes that digest only (phase 10)
STORM_REFERENCE = [
    {"admitted": 600, "evicted": 0, "rounds": 22, "held": 600,
     "digest": "e127c72662d418820e4abaa29e4e4b0d03ed02f9d7e97c6b59a3aa27"
               "f87fedc9"},
    {"admitted": 30, "evicted": 600, "rounds": 6, "held": 30,
     "digest": "58b39babac12c4d6630e0d5d724f07a8501a4cde09c100302e2cb817"
               "f4c39761"},
]
#: the JAX package's plans of phases 8 and 9 (its engine without mesh
#: and delta sessions, as above)
FAIR_REFERENCE = [
    {"admitted": 600, "evicted": 0, "rounds": 62, "held": 600,
     "digest": "557f26ef39c557381aed73eb4a46b1e81ff5549c79976443e68206830a"
               "cb92ac"},
    {"admitted": 10, "evicted": 200, "rounds": 7, "held": 410,
     "digest": "6fc8e8418aca1c51ad7d813faeb77db054333343fceb1c8a03d6c07cd1"
               "aab6bc"},
]
FAIR_REASONS = {"InCohortReclamation": 100, "InCohortFairSharing": 100}
#: the JAX package's plans of phase 10, per drain: its engine with
#: ``mesh_mode="off"`` and delta sessions on, on the same sequence
#: (``JAX_PLATFORMS=cpu python tests/test_torch_engine_sessions.py``
#: prints them); ``frame`` is its session frame's kind ("delta" or the
#: full sync's reason) and ``held`` counts QuotaReserved workloads,
#: finished ones included
STORM_CHURN_REFERENCE = [
    {"label": "wave1", "now": 100.0, "admitted": 600, "evicted": 0,
     "rounds": 22, "held": 600, "reasons": {},
     "frame": "first_sync",
     "digest": "e127c72662d418820e4abaa29e4e4b0d03ed02f9d7e97c6b59a3aa27"
               "f87fedc9"},
    {"label": "wave2", "now": 200.0, "admitted": 30, "evicted": 600,
     "rounds": 6, "held": 30, "reasons": {"InClusterQueue": 600},
     "frame": "dense_delta",
     "digest": "b0fb9ed57388273d10976583bea4859801e80748fa8208f2de95c9a7"
               "821571ef"},
    {"label": "cycle1", "now": 201.0, "admitted": 30, "evicted": 0,
     "rounds": 6, "held": 60, "reasons": {},
     "frame": "dense_delta",
     "digest": "5cdb03e7dadf95d9a77c59af866294c4c3997a8d426927b8f75538a6"
               "3314e492"},
    {"label": "cycle2", "now": 202.0, "admitted": 30, "evicted": 0,
     "rounds": 6, "held": 90, "reasons": {},
     "frame": "delta",
     "digest": "54cec1760ba9c6b7839e73b711d95b02e2f60d7f7e95bb23e3cc89d7"
               "8ba8fc0a"},
    {"label": "cycle3", "now": 203.0, "admitted": 30, "evicted": 0,
     "rounds": 6, "held": 120, "reasons": {},
     "frame": "delta",
     "digest": "2c76b639ceb43cb2fb2b1333b2605a50fb5bd44c768a828ef78d5377"
               "4311cd60"},
    {"label": "cycle4", "now": 204.0, "admitted": 30, "evicted": 0,
     "rounds": 6, "held": 150, "reasons": {},
     "frame": "delta",
     "digest": "5577f18f1070adb335c336c652fd5c54cd54d8734852f8a45af5c3bf"
               "868b33b9"},
    {"label": "cycle5", "now": 205.0, "admitted": 30, "evicted": 0,
     "rounds": 6, "held": 180, "reasons": {},
     "frame": "delta",
     "digest": "ae6979acfd93d4065a0527553723a007b0043cfc0c1282a3137ae98c"
               "1a38303d"},
    {"label": "cycle6", "now": 206.0, "admitted": 30, "evicted": 0,
     "rounds": 6, "held": 210, "reasons": {},
     "frame": "delta",
     "digest": "f0300105abea815d8ae83b7cbc510de097e83522bf454b24100df228"
               "12ce7bd1"},
    {"label": "cycle7", "now": 207.0, "admitted": 30, "evicted": 0,
     "rounds": 6, "held": 240, "reasons": {},
     "frame": "delta",
     "digest": "e311bc0f15b712511e2bf6a74e3b6cc500646e4ef8487c436fcd9253"
               "537dc844"},
    {"label": "cycle8", "now": 208.0, "admitted": 30, "evicted": 0,
     "rounds": 6, "held": 270, "reasons": {},
     "frame": "delta",
     "digest": "ebaeaccd72b07913b3c383fe38eb2dc24dd197ce4828e9c257059fb2"
               "02ed3aad"},
    {"label": "cycle9", "now": 209.0, "admitted": 30, "evicted": 0,
     "rounds": 6, "held": 300, "reasons": {},
     "frame": "delta",
     "digest": "16f8abd131f764d08023ca1e953e5b79085572d676a956e78a45323c"
               "803c0a89"},
    {"label": "cycle10", "now": 210.0, "admitted": 30, "evicted": 0,
     "rounds": 6, "held": 330, "reasons": {},
     "frame": "delta",
     "digest": "1315edc0b53d2f36841976a988dd9166ee0b7287ef8b743d9d828b26"
               "9397e051"},
]
AFS_REFERENCE = {
    "admitted": 600, "evicted": 0, "rounds": 22, "held": 600,
    "digest": "98a7dccfc9b09fb8e496277cf113dbb7a5107fc943c8e711863c1fda44"
              "f8c244",
    "sides": {"a": 30, "b": 570}}
#: search lanes per FULL round at C = 30, K = 1, g = 1
H_MAX = 32
TAS_FULL_REFERENCE = {
    "admitted": 215, "evicted": 0, "rounds": 277, "parked": 1285,
    "digest": "1f78efb7540ae640e5f2d1ce613a9393e0c7c6c4201d882b673101623d"
              "686a0b"}
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor fp32 ops/s
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def _bound(nbytes: int, nops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    return {"name": "leaf_states", "route": "cuda", "impl": "cuda",
            "source": "kueue_oss_tpu_torch/csrc/leaf_states.cu",
            "replaces": "kueue_oss_tpu/solver/pallas_tas.py:99",
            "max_abs_err": max_err, "exact": max_err == 0,
            "shape": [D, R], "ms": ms, "plain_ms": plain_ms,
            "kernel_us": ms * 1e3, "plain_us": plain_ms * 1e3,
            **_bound(nbytes, nops), "library_ms": None}


def _place_inputs(cap, req, device):
    import torch

    from kueue_oss_tpu_torch.scenarios import PLACER_INPUTS

    return [torch.as_tensor(cap, device=device)] + [
        torch.as_tensor(req[k], device=device) for k in PLACER_INPUTS]


def _check_place(name, tree, inputs) -> int:
    """Kernel against its plain version on one batch, exactly; returns
    the max abs error (0)."""
    import torch

    from kueue_oss_tpu_torch.solver import cuda_tas

    leaf_before = cuda_tas.leaf_states.launches
    got = cuda_tas.tas_place_sequential(tree, *inputs)
    want = cuda_tas.tas_place_sequential_reference(tree, *inputs)
    torch.cuda.synchronize()
    if cuda_tas.leaf_states.launches != leaf_before:
        raise AssertionError("the plain placer launched leaf_states")
    err = 0
    for g, w, out in zip(got, want, ("sels", "leads", "oks", "cap")):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"tas_place_sequential {out} is {g.dtype}"
                                 f"{tuple(g.shape)}, plain {w.dtype}"
                                 f"{tuple(w.shape)} on case {name!r}")
        e = int((g.long() - w.long()).abs().max()) if g.numel() else 0
        err = max(err, e)
        if not torch.equal(g, w):
            raise AssertionError(
                f"tas_place_sequential {out} differs from the plain version "
                f"on case {name!r} (max abs err {e})")
    return err


def check_tas_place(device) -> dict:
    """Phase 3 for ``tas_place_sequential``: exact agreement on every
    case, then the times at the drain's shape (plain, kernel, kernel,
    plain)."""
    import numpy as np
    import torch

    from kueue_oss_tpu_torch import scenarios as sc
    from kueue_oss_tpu_torch.solver import cuda_tas

    rng = np.random.default_rng(2)
    cases = []
    parents, drain_cap, req = sc.drain_placer_batch()
    drain = (cuda_tas.PlacerTree(parents),
             _place_inputs(drain_cap, req, device))
    cases.append(("drain batch 1x10x64 R=2 M=102",) + drain)
    for n_levels in (2, 3, 4):
        for seed in range(4):
            parents, cap = sc.random_placer_tree(
                n_levels, seed, min_children=seed % 2,
                max_children=(4, 40)[seed // 2])
            req = sc.random_placer_requests(rng, n_levels, cap.shape[1], 24,
                                            pre_rejected=0.1)
            cases.append((f"random L={n_levels} seed={seed} "
                          f"sizes={[len(p) for p in parents]}",
                          cuda_tas.PlacerTree(parents),
                          _place_inputs(cap, req, device)))
    parents, cap = sc.random_placer_tree(3, 9)
    req = sc.random_placer_requests(rng, 3, cap.shape[1], 40,
                                    pre_rejected=0.5)
    cases.append(("pre-rejected rows", cuda_tas.PlacerTree(parents),
                  _place_inputs(cap, req, device)))
    empty = sc.random_placer_requests(rng, 3, 2, 0)
    cases.append(("M = 0", drain[0], _place_inputs(drain_cap, empty,
                                                   device)))
    for racks, hosts, shared in ((20, 64, True), (64, 128, False)):
        parents, cap, _ = sc.drain_placer_batch(1, n_racks=racks,
                                                n_hosts=hosts)
        cap = rng.integers(0, 200, size=cap.shape).astype(np.int32)
        tree = cuda_tas.PlacerTree(parents)
        if tree.uses_shared(2) != shared:
            raise AssertionError(f"1x{racks}x{hosts}: footprint "
                                 f"{tree.footprint_bytes(2)} B")
        req = sc.random_placer_requests(rng, 3, 2, 24, pre_rejected=0.1)
        cases.append((f"1x{racks}x{hosts} R=2 state "
                      f"{tree.footprint_bytes(2)} B in "
                      f"{'shared' if shared else 'global'} memory", tree,
                      _place_inputs(cap, req, device)))
    max_err = 0
    for name, tree, inputs in cases:
        max_err = max(max_err, _check_place(name, tree, inputs))
    print(f"[kernel] tas_place_sequential == tas_place_sequential_reference "
          f"exactly on {len(cases)} cases: "
          + "; ".join(c[0] for c in cases))

    tree, inputs = drain
    turns = []
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "kernel":
            turns.append(_time_ms(
                lambda: cuda_tas.tas_place_sequential(tree, *inputs),
                iters=50, warmup=5))
        else:
            turns.append(_time_ms(
                lambda: cuda_tas.tas_place_sequential_reference(tree,
                                                                *inputs),
                iters=2, warmup=1))
    print(f"[kernel] tas_place_sequential at the drain's shape, ms per "
          f"batch (plain, kernel, kernel, plain): {turns}")
    D, R = inputs[0].shape
    M = inputs[1].shape[0]
    L, N = tree.n_levels, tree.n_domains
    # each input read once (capacity, requests, the tree), each output
    # written once (sels, leads, oks, capacity after)
    nbytes = (4 * D * R + 4 * 2 * M * R + 4 * 4 * M + 4 * M
              + 4 * (L + 3 * N) + 4 * M * D + 4 * M + M + 4 * D * R)
    # per step: the leaf pass (compare, divide, min per element, twice)
    # and one pass over every domain's state
    nops = M * (8 * D * R + 12 * N)
    return {"name": "tas_place_sequential", "route": "cuda",
            "source": "kueue_oss_tpu_torch/csrc/tas_place.cu",
            "replaces": "kueue_oss_tpu/solver/pallas_tas.py:99 (with the "
                        "lax.scan of kueue_oss_tpu/solver/tas_kernels.py:"
                        "250-283)",
            "max_abs_err": max_err, "shape": [M, D, R],
            "ms": (turns[1] + turns[2]) / 2,
            "plain_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns,
            **_bound(nbytes, nops), "library_ms": None}


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


def _drain_store():
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import tas_drain_store

    store = tas_drain_store(types, Store)
    return store, QueueManager(store)


def _placed(store, result) -> int:
    return sum(1 for k in result.admitted_keys
               if store.workloads[k].status.admission
               .podset_assignments[0].topology_assignment is not None)


def drain_with_stepwise_placer(device):
    """Phase 4: the full drain placed stepwise (the plain sequential
    placer, its leaf pass the CUDA leaf_states kernel, one launch per
    podset). Returns (phases, the placed batch)."""
    import torch

    from kueue_oss_tpu_torch.solver import cuda_tas, tas_kernels
    from kueue_oss_tpu_torch.solver.engine import SolverEngine
    from kueue_oss_tpu_torch.solver.tas_engine import DeviceTASPlacer

    class StepwisePlacer(DeviceTASPlacer):
        batches = []

        def _place(self, tree, *inputs):
            self.batches.append((tree, inputs))
            return tas_kernels.make_sequential_placer_ext(
                tree.parents, self.device)(*inputs)

    store, queues = _drain_store()
    engine = SolverEngine(store, queues)
    engine._tas_placer = StepwisePlacer(engine.device)
    before = cuda_tas.leaf_states.launches
    _settle()
    t0 = time.monotonic()
    result = engine.drain(now=0.0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check_plan(store, queues, result)
    launches = cuda_tas.leaf_states.launches - before
    if launches != _placed(store, result) or len(StepwisePlacer.batches) != 1:
        raise AssertionError(f"stepwise placer: {launches} leaf_states launches "
                             f"for {_placed(store, result)} placements")
    phases = {"drain_s": wall,
              **{f"{k}_s": v for k, v in result.phases.items()}}
    print("[stepwise-placer drain] " + json.dumps(phases))
    return phases, StepwisePlacer.batches[0]


def _quota_checks(store) -> None:
    """No ClusterQueue above nominal + borrowing limit and no cohort
    above its members' nominal quota, summed over the workloads that
    hold quota now (a finished workload released its quota)."""
    cq_cpu: dict[str, int] = {}
    for wl in store.workloads.values():
        if wl.is_quota_reserved and not wl.is_finished:
            adm = wl.status.admission
            cq_cpu[adm.cluster_queue] = cq_cpu.get(adm.cluster_queue, 0) + sum(
                psa.resource_usage.get("cpu", 0)
                for psa in adm.podset_assignments)
    cohort_cpu: dict[str, int] = {}
    cohort_nominal: dict[str, int] = {}
    for name, spec in store.cluster_queues.items():
        rq = spec.resource_groups[0].flavors[0].resources[0]
        used = cq_cpu.get(name, 0)
        if used > rq.nominal + rq.borrowing_limit:
            raise AssertionError(f"ClusterQueue {name} over its nominal + "
                                 f"borrowing limit: {used}")
        cohort_cpu[spec.cohort] = cohort_cpu.get(spec.cohort, 0) + used
        cohort_nominal[spec.cohort] = (cohort_nominal.get(spec.cohort, 0)
                                       + rq.nominal)
    for cohort, used in cohort_cpu.items():
        if used > cohort_nominal[cohort]:
            raise AssertionError(f"cohort {cohort} over quota: {used}")


def _check_storm_wave(store, result, before, reference) -> dict:
    """One wave of phase 6 against the JAX plan and the independent
    checks; ``before`` is (reserved keys, CQ of each, CQ cpu usage)
    taken just before the drain."""
    from kueue_oss_tpu_torch.scenarios import preempt_plan_digest

    held = sum(1 for w in store.workloads.values() if w.is_quota_reserved)
    got = {"admitted": result.admitted, "evicted": result.evicted,
           "rounds": result.rounds, "held": held,
           "digest": preempt_plan_digest(store, result)}
    if got != reference:
        raise AssertionError(f"plan {got} != reference {reference}")
    _quota_checks(store)
    reserved0, cq_of, cq_used0 = before
    flipped = {k for k in reserved0
               if not store.workloads[k].is_quota_reserved}
    if (len(result.evicted_keys) != len(set(result.evicted_keys))
            or set(result.evicted_keys) != flipped):
        raise AssertionError("evicted_keys differ from the workloads whose "
                             "QuotaReserved flipped to false")
    nominal = {name: spec.resource_groups[0].flavors[0].resources[0].nominal
               for name, spec in store.cluster_queues.items()}
    preemptor_prio: dict[str, int] = {}
    for key in result.admitted_keys:
        wl = store.workloads[key]
        cq = wl.status.admission.cluster_queue
        preemptor_prio[cq] = max(preemptor_prio.get(cq, wl.priority),
                                 wl.priority)
    for key in result.evicted_keys:
        wl = store.workloads[key]
        cq = cq_of[key]
        own = preemptor_prio.get(cq)
        borrowing = cq_used0.get(cq, 0) > nominal[cq]
        if not ((own is not None and wl.priority < own) or borrowing):
            raise AssertionError(f"victim {key} of {cq} is neither below a "
                                 f"preemptor of its ClusterQueue nor "
                                 f"admitted in a borrowing one")
    return got


def _reserved_state(store):
    reserved = {k for k, w in store.workloads.items()
                if w.is_quota_reserved and not w.is_finished}
    cq_of = {k: store.workloads[k].status.admission.cluster_queue
             for k in reserved}
    used: dict[str, int] = {}
    for k in reserved:
        for psa in store.workloads[k].status.admission.podset_assignments:
            used[cq_of[k]] = used.get(cq_of[k], 0) + psa.resource_usage.get(
                "cpu", 0)
    return reserved, cq_of, used


def _stats(result) -> dict:
    st = result.full_stats
    return {"rounds": st.rounds, "lanes": st.lanes,
            "walk_iterations": st.walk_iterations,
            "fill_iterations": st.fill_iterations,
            "removal_steps": st.removal_steps,
            "entry_picks": st.entry_picks, "syncs": st.syncs}


def storm_drain() -> dict:
    """Phase 6: the baseline preemption storm at full size, two waves."""
    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import baseline_preempt_store
    from kueue_oss_tpu_torch.solver import cuda_tas
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    store, wave1, wave2 = baseline_preempt_store(types, Store)
    engine = SolverEngine(store, QueueManager(store))
    engine.use_sessions = False  # STORM_REFERENCE pins sessions off
    out = {}
    for name, now, wave, reference in (
            ("wave1", 100.0, wave1, STORM_REFERENCE[0]),
            ("wave2", 200.0, wave2, STORM_REFERENCE[1])):
        for wl in wave:
            store.add_workload(wl)
        before = _reserved_state(store)
        cuda_tas.leaf_states.launches = 0
        cuda_tas.tas_place_sequential.launches = 0
        _settle()
        t0 = time.monotonic()
        result = engine.drain(now=now)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if (cuda_tas.leaf_states.launches
                or cuda_tas.tas_place_sequential.launches):
            raise AssertionError("the storm has no TAS flavor, yet a TAS "
                                 "kernel launched")
        got = _check_storm_wave(store, result, before, reference)
        out[name] = {"drain_s": wall,
                     **{f"{k}_s": v for k, v in result.phases.items()},
                     "workloads": len(wave), **_stats(result)}
        print(f"[storm {name}] plan matches the reference {got}; FULL "
              f"drain counters " + json.dumps(_stats(result)))
    return out


def tas_full_drain() -> tuple:
    """Phase 7: the TAS store with preemption through the FULL path.
    Returns (timings, tas_place_sequential launches)."""
    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import plan_digest, tas_drain_store
    from kueue_oss_tpu_torch.solver import cuda_tas
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    store = tas_drain_store(types, Store, n_workloads=1500, preempt=True)
    queues = QueueManager(store)
    engine = SolverEngine(store, queues)
    engine.use_sessions = False
    cuda_tas.leaf_states.launches = 0
    cuda_tas.tas_place_sequential.launches = 0
    cuda_tas.tas_place_sequential.steps = 0
    _settle()
    t0 = time.monotonic()
    result = engine.drain(now=0.0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = cuda_tas.tas_place_sequential.launches
    steps = cuda_tas.tas_place_sequential.steps
    placed = _placed(store, result)
    if (launches != 1 or steps != placed or placed != result.admitted
            or cuda_tas.leaf_states.launches != 0):
        raise AssertionError(
            f"TAS FULL path: {launches} tas_place_sequential launches "
            f"({steps} steps), {cuda_tas.leaf_states.launches} leaf_states "
            f"launches for {placed} placements of {result.admitted}")
    got = {"admitted": result.admitted, "evicted": result.evicted,
           "rounds": result.rounds,
           "parked": sum(len(q.inadmissible)
                         for q in queues.queues.values()),
           "digest": plan_digest(store, result.admitted_keys)}
    if got != TAS_FULL_REFERENCE:
        raise AssertionError(f"plan {got} != reference {TAS_FULL_REFERENCE}")
    _quota_checks(store)
    print(f"[tas full] plan matches the reference {got}; 1 "
          f"tas_place_sequential launch, {steps} steps, 0 leaf_states "
          f"launches; FULL drain counters " + json.dumps(_stats(result)))
    return ({"drain_s": wall,
             **{f"{k}_s": v for k, v in result.phases.items()},
             **_stats(result)}, launches)


def _reset_launches() -> None:
    from kueue_oss_tpu_torch.solver import cuda_tas

    cuda_tas.leaf_states.launches = 0
    cuda_tas.tas_place_sequential.launches = 0


def _launches() -> int:
    from kueue_oss_tpu_torch.solver import cuda_tas

    return (cuda_tas.leaf_states.launches
            + cuda_tas.tas_place_sequential.launches)


def _settle() -> None:
    """A full garbage-collector pass before a timed drain. Building a
    store of thousands of workloads leaves one due, and it would land in
    whichever phase of the next drain allocates enough first, so the
    drains are timed without that set-up debt and their phase times do
    not depend on where the pass falls."""
    gc.collect()


def _cq_shares(store) -> dict:
    """Each ClusterQueue's dominant resource share (host DRS)."""
    from kueue_oss_tpu_torch.core.quota import dominant_resource_share
    from kueue_oss_tpu_torch.core.snapshot import build_snapshot

    forest = build_snapshot(store).forest
    return {name: dominant_resource_share(node).precise_weighted_share()
            for name, node in sorted(forest.cqs.items())}


def fair_storm_drain() -> tuple:
    """Phase 8: the fair reclamation storm at full size, two waves.
    Returns (timings, TAS kernel launches)."""
    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import fair_reclaim_store
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    store, wave1, wave2 = fair_reclaim_store(types, Store)
    engine = SolverEngine(store, QueueManager(store),
                          enable_fair_sharing=True)
    engine.use_sessions = False  # FAIR_REFERENCE pins sessions off
    out, launches = {}, 0
    for name, now, wave, reference in (
            ("wave1", 100.0, wave1, FAIR_REFERENCE[0]),
            ("wave2", 200.0, wave2, FAIR_REFERENCE[1])):
        for wl in wave:
            store.add_workload(wl)
        before = _reserved_state(store)
        _reset_launches()
        _settle()
        t0 = time.monotonic()
        result = engine.drain(now=now)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches += _launches()
        if _launches():
            raise AssertionError("the fair storm has no TAS flavor, yet a "
                                 "TAS kernel launched")
        got = _check_storm_wave(store, result, before, reference)
        reasons = dict(collections.Counter(
            store.workloads[k].status.conditions["Preempted"].reason
            for k in result.evicted_keys))
        if reasons != (FAIR_REASONS if result.evicted else {}):
            raise AssertionError(f"victims' reasons {reasons}")
        if result.full_stats.lanes != H_MAX * result.rounds:
            raise AssertionError(f"{result.full_stats.lanes} search lanes "
                                 f"in {result.rounds} rounds; h_max is not "
                                 f"{H_MAX}")
        out[name] = {"drain_s": wall,
                     **{f"{k}_s": v for k, v in result.phases.items()},
                     "workloads": len(wave), **_stats(result)}
        print(f"[fair {name}] plan matches the reference {got}, reasons "
              f"{reasons}; FULL drain counters " + json.dumps(_stats(result))
              + f"; {json.dumps(out[name])}")
        print(f"[fair {name}] dominant resource share per ClusterQueue "
              + json.dumps(_cq_shares(store)))
    return out, launches


def afs_drain() -> tuple:
    """Phase 9: the admission-fair-sharing backlog at full size.
    Returns (timings, TAS kernel launches)."""
    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.afs import AfsManager
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import (
        afs_baseline_store,
        preempt_plan_digest,
    )
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    store, afs, backlog = afs_baseline_store(types, Store, AfsManager)
    engine = SolverEngine(store, QueueManager(store, afs=afs))
    engine.use_sessions = False  # AFS_REFERENCE pins sessions off
    for wl in backlog:
        store.add_workload(wl)
    _reset_launches()
    _settle()
    t0 = time.monotonic()
    result = engine.drain(now=60.0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launches()
    if launches:
        raise AssertionError("the AFS backlog has no TAS flavor, yet a TAS "
                             "kernel launched")
    got = {"admitted": result.admitted, "evicted": result.evicted,
           "rounds": result.rounds,
           "held": sum(1 for w in store.workloads.values()
                       if w.is_quota_reserved),
           "digest": preempt_plan_digest(store, result),
           "sides": dict(sorted(collections.Counter(
               store.workloads[k].queue_name[-1]
               for k in result.admitted_keys).items()))}
    if got != AFS_REFERENCE:
        raise AssertionError(f"plan {got} != reference {AFS_REFERENCE}")
    _quota_checks(store)
    out = {"drain_s": wall, **{f"{k}_s": v for k, v in result.phases.items()},
           "workloads": len(backlog), **_stats(result)}
    print(f"[afs] plan matches the reference {got}; FULL drain counters "
          + json.dumps(_stats(result)) + f"; {json.dumps(out)}")
    return out, launches


def _decisions(store, result) -> tuple:
    """A drain's decisions, row order aside: each admitted key's
    ClusterQueue and flavors, each evicted key's Preempted reason."""
    adm = {}
    for key in result.admitted_keys:
        a = store.workloads[key].status.admission
        adm[key] = (a.cluster_queue, [sorted(p.flavors.items())
                                      for p in a.podset_assignments])
    ev = {k: store.workloads[k].status.conditions["Preempted"].reason
          for k in result.evicted_keys}
    return adm, ev


def _frame_summary(result) -> dict:
    """The session frame's kind, dirty rows and update bytes (the
    row-update and replacement payload a delta ships)."""
    import numpy as np

    frame = result.frame
    if frame is None:
        return {"frame": None}
    if frame.delta is None:
        return {"frame": frame.full_reason}
    rows = [idx for idx, _ in frame.delta.row_updates.values()]
    dirty = int(np.unique(np.concatenate(rows)).size) if rows else 0
    return {"frame": "delta", "dirty_rows": dirty,
            "update_bytes": frame.delta.payload_bytes(),
            "fields": sorted(frame.delta.row_updates),
            "replaced": sorted(frame.delta.repl)}


def storm_churn_drain() -> tuple:
    """Phase 10: the baseline storm under churn, sessions on, against
    the JAX plans, with a sessions-off twin. Returns (per-drain report,
    TAS kernel launches)."""
    import numpy as np
    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.eviction import finish_workload
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import (
        baseline_preempt_store,
        storm_churn_drains,
    )
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    def setup(sessions: bool):
        store, wave1, wave2 = baseline_preempt_store(types, Store)
        queues = QueueManager(store)
        engine = SolverEngine(store, queues)
        engine.use_sessions = sessions
        steps = storm_churn_drains(
            types, store, wave1, wave2,
            lambda key, now: finish_workload(store, queues, key, now))
        return store, engine, steps

    store, engine, steps = setup(True)
    twin_store, twin, twin_steps = setup(False)
    if not engine.use_sessions:
        raise AssertionError("sessions are not the engine's default")
    out, launches = [], 0
    for i, ((label, now), step) in enumerate(zip(steps, twin_steps)):
        reference = STORM_CHURN_REFERENCE[i]
        if (label, now) != (reference["label"], reference["now"]) or (
                step != (label, now)):
            raise AssertionError(f"drain {i}: {label} at {now}, twin "
                                 f"{step}, reference {reference['label']}")
        row = {"label": label}
        for name, st, eng, ref in (
                ("sessions", store, engine, reference),
                ("twin", twin_store, twin, None)):
            before = _reserved_state(st)
            _reset_launches()
            _settle()
            t0 = time.monotonic()
            result = eng.drain(now=now)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches += _launches()
            if _launches():
                raise AssertionError("the storm has no TAS flavor, yet a "
                                     "TAS kernel launched")
            if ref is not None:
                want = {k: ref[k] for k in ("admitted", "evicted", "rounds",
                                            "held", "digest")}
                got = _check_storm_wave(st, result, before, want)
                reasons = dict(collections.Counter(
                    st.workloads[k].status.conditions["Preempted"].reason
                    for k in result.evicted_keys))
                frame = _frame_summary(result)
                if (reasons != ref["reasons"]
                        or frame["frame"] != ref["frame"]):
                    raise AssertionError(
                        f"{label}: reasons {reasons}, frame {frame} != "
                        f"reference {ref['reasons']}, {ref['frame']}")
                decisions = _decisions(st, result)
                row.update(frame)
            else:
                _quota_checks(st)
                if _decisions(st, result) != decisions:
                    raise AssertionError(f"{label}: the sessions-off twin "
                                         f"decided otherwise")
            row[name] = {"drain_s": wall, "rounds": result.rounds,
                         **{f"{k}_s": v for k, v in result.phases.items()},
                         **result.device, **result.export_stats}
        out.append(row)
        print(f"[storm churn {label}] plan matches the reference "
              f"({got['admitted']} admitted, {got['evicted']} evicted, "
              f"{got['rounds']} rounds); twin agrees; " + json.dumps(row))

    dev = engine._device_states["full"]
    slotted = engine._delta_sessions["full"]._last_slotted
    fresh = dev._host(slotted, True)
    for name, t, h in zip(dev.tensors._fields, dev.tensors, fresh):
        if not torch.equal(t, torch.from_numpy(np.asarray(h)).to(t.device)):
            raise AssertionError(f"resident {name} differs from a fresh "
                                 f"upload of the last slotted problem")
    kinds = [r["frame"] for r in out]
    n_delta = kinds.count("delta")
    if (dev.apply_faults or dev.delta_updates != n_delta
            or dev.full_uploads != len(kinds) - n_delta):
        raise AssertionError(
            f"resident state: {dev.full_uploads} full uploads, "
            f"{dev.delta_updates} delta updates, {dev.apply_faults} "
            f"faults for frames {kinds}")
    print(f"[storm churn] resident FULL tensors equal a fresh upload of "
          f"the last slotted problem; {dev.full_uploads} full uploads "
          f"({dev.donated_full_syncs} in place), {dev.delta_updates} delta "
          f"updates, {dev.full_upload_bytes} full-upload bytes, "
          f"{dev.donated_update_bytes} bytes written in place")
    return {"drains": out, "full_uploads": dev.full_uploads,
            "delta_updates": dev.delta_updates,
            "donated_full_syncs": dev.donated_full_syncs,
            "resident_bytes": dev.resident_bytes()}, launches


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

    for line in cuda_tas.ptxas_report(lib).splitlines():
        if any(w in line for w in ("Compiling entry", "registers",
                                   "spill")):
            print(f"[build] ptxas: {line.strip()}")

    # 3. kernel vs plain
    device = torch.device("cuda")
    reports = [check_leaf_states(device), check_tas_place(device)]

    # 4. stepwise placement, for the placement phase before the kernel
    step_phases, (step_tree, step_batch) = drain_with_stepwise_placer(
        device)

    # 5. main path at full size
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    t0 = time.monotonic()
    store, queues = _drain_store()
    engine = SolverEngine(store, queues)
    setup_s = time.monotonic() - t0
    cuda_tas.leaf_states.launches = 0
    cuda_tas.tas_place_sequential.launches = 0
    cuda_tas.tas_place_sequential.steps = 0
    _settle()
    t0 = time.monotonic()
    result = engine.drain(now=0.0)
    torch.cuda.synchronize()
    drain_s = time.monotonic() - t0
    leaf_launches = cuda_tas.leaf_states.launches
    place_launches = cuda_tas.tas_place_sequential.launches
    steps = cuda_tas.tas_place_sequential.steps
    placed = _placed(store, result)
    if leaf_launches != 0 or place_launches != 1 or steps != placed:
        raise AssertionError(
            f"main path: {place_launches} tas_place_sequential launches "
            f"({steps} steps) and {leaf_launches} leaf_states launches for "
            f"{placed} placements; expected 1 ({placed}) and 0")
    check_plan(store, queues, result)
    if (result.frame is None or result.frame.full_reason != "first_sync"
            or result.device.get("full_uploads") != 1):
        raise AssertionError(f"main path: session frame {result.frame}, "
                             f"device {result.device}; expected the "
                             f"sessions' first sync")
    replay_err = _check_place("the drain's placement batch", step_tree,
                              list(step_batch))
    print(f"[main] 1 tas_place_sequential launch, {steps} steps, "
          f"0 leaf_states launches; the drain's batch agrees exactly "
          f"(max abs err {replay_err}); sessions on: first_sync, "
          f"{result.device['full_upload_bytes']} bytes uploaded")
    reports[0]["launches"] = leaf_launches
    reports[1]["launches"] = place_launches
    reports[1]["steps"] = steps

    # 6. the baseline preemption storm (FULL path, no TAS kernel)
    storm = storm_drain()

    # 7. TAS with preemption (FULL path)
    tas_full, tas_full_launches = tas_full_drain()

    # 8. the fair reclamation storm (FULL path, fair sharing)
    fair, fair_launches = fair_storm_drain()

    # 9. the admission-fair-sharing backlog (FULL path, AFS)
    afs, afs_launches = afs_drain()

    # 10. the storm under churn with delta sessions (FULL path)
    churn, churn_launches = storm_churn_drain()
    reports[0]["launches_by_path"] = {"tas_lean": leaf_launches,
                                      "tas_full": 0, "storm_full": 0,
                                      "fair_storm": fair_launches,
                                      "afs": afs_launches,
                                      "storm_churn": churn_launches}
    reports[1]["launches_by_path"] = {"tas_lean": place_launches,
                                      "tas_full": tas_full_launches,
                                      "storm_full": 0,
                                      "fair_storm": fair_launches,
                                      "afs": afs_launches,
                                      "storm_churn": churn_launches}

    timings = {"setup_s": setup_s, "drain_s": drain_s,
               **{f"{k}_s": v for k, v in result.phases.items()},
               "rounds": result.rounds, "admitted": result.admitted,
               "stepwise_placer": step_phases, "storm": storm,
               "tas_full": tas_full, "fair_storm": fair, "afs": afs,
               "storm_churn": churn}
    print("[timings] " + json.dumps(timings))
    print(smi)
    print(json.dumps({"kernels": reports}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

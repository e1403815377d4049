#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (kueue_oss_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure propagates (nonzero exit, no result line):

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: compile every CUDA kernel from the sources in the checkout
   (``leaf_states.cu``, ``tas_place.cu``, ``fill_counts.cu``,
   ``relax_lp.cu``; one nvcc call, at first use) and report the build
   seconds and what ptxas said about each kernel (registers, shared
   memory, spills); then
   build the verify oracle (host C++, g++) that phases 11-13 run;
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
   - ``fill_counts`` at phase 14's fill shape (the 1 x 10 x 64 tree,
     R = 2), on that tree with slices at every level with and without a
     leader, on random 1-4 level trees with zero-capacity leaves and
     childless domains, and on a tree whose states exceed shared
     memory (they live in the output buffer);
4. stepwise placement: the TAS drain cut to its first 1,500 workloads
   (which hold all 102 admissions of the full store: the same plan in
   66 rounds) placed by the plain sequential placer with the CUDA leaf
   pass (one leaf_states launch per podset, ~350 eager ops per podset
   around it), the placement path before tas_place_sequential, for its
   placement phase; its plan must be the JAX plan of that store;
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
11. scheduler storm (the system's entry point): the phase 6 store at
   full size through ``Scheduler(store, queues, solver="auto")`` (its
   engine on the card, sessions on, default ``solver_min_backlog``):
   wave 1 by ``run_until_quiet(now=100.0, tick=0.001)``, wave 2 at
   200.0. Per wave the JAX scheduler's record (pinned below: the
   committed-store digest, held / evicted / reason counts, host cycles,
   one device drain), the verify oracle native on every candidate with
   no rejection, no plan fallback, no UnsupportedProblem or
   SolverUnavailable fallback, and the quota and victim checks of
   phase 6. A host-only twin (``solver=None``) on a second store must
   reach the same store in the JAX host-only cycle counts (22 and 6).
   Both walls are printed, with the drain's phases;
12. scheduler TAS: the phase 5 store at full size through
   ``Scheduler(solver="auto")``: the JAX scheduler's record (102 held,
   14,898 parked, one drain, one empty host cycle: no host TAS head),
   phase 5's plan digest and rounds, one tas_place_sequential launch
   placing 102 podsets, no leaf_states launch;
13. refused backlog: the storm with memory quotas and requests in bytes
   (``scenarios.refused_quantity_store``), which every drain refuses at
   export ("quantities too large for int32 solver tensors"), through
   ``Scheduler(solver="auto")``: exactly one UnsupportedProblem
   fallback per ``run_until_quiet`` pass (1, then 2), no drain
   committing anything, and the host cycles reaching the JAX
   scheduler's store (22, then 8 cycles).
14. scheduler TAS, host placement: the mixed TAS store
   (``scenarios.tas_mixed_store``: phase 5's cluster and queues in
   millicores, 15,000 workloads of bench.py's plain and extended TAS
   mixes, leader + workers groups only in ClusterQueues 3-5 of each
   cohort), nothing cut, in four ``run_until_quiet(now=100.0,
   tick=0.001)`` runs: (a) ``Scheduler(solver="auto")`` with
   TASDeviceFillCounts off, (b) the same with it on, (c) host-only
   (``solver=None, device="cuda"``) with it on, (d) host-only with it
   off. Each run must equal the JAX scheduler's record (digest, held,
   parked and leader-group counts, host cycles, device drains, the
   host placement's ``_fill_in_counts`` calls); the pins of (a) and
   (b), and of (c) and (d), are equal (the tests hold them so), so the
   two fill modes give the same digest; ``fill_counts`` launches once
   per fill in (b) and (c) and never in (a) and (d), ``leaf_states``
   never; ``tas_place_sequential`` launches once per drain in (a) and
   (b) and never in (c) and (d).
   With the gate on, every fill's five states on every domain are held
   against the host roll-up of the same leaves. Every admitted workload
   passes independent topology checks: no node over its allocatable,
   a required-rack podset (and a leader group) in one rack, every slice
   whole in its slice domain. One fill's inputs are held and timed
   through ``fill_counts`` and its plain version, and its leaf tile
   through ``leaf_states`` and its plain version; the device fill's
   cost a fill over the host roll-up is timed fill by fill in (c): the
   device fill less the host division and roll-up of the same leaves.
15. streaming admission: bench.py's streaming arm
   (``scenarios.streaming_store`` / ``streaming_ticks``, bench.py:
   2153-2276) through ``Scheduler(solver="auto", solver_min_backlog=0,
   streaming=...)``: a full drain at t = 0 arms the fences, then per 10
   ms virtual tick a ``micro_drain`` and the tick's arrivals, and a full
   ``engine.drain(verify=True)`` every 100 ticks. (a) the ``single``
   fleet (32 standalone one-flavor ClusterQueues, nominal 10,000,000,
   requests 100 cpu) at 128 arrivals a tick for 200 ticks (25,600
   workloads; bench.py runs 400 ticks: cut for the phase's time, two
   boundaries kept), so every micro-drain is a 128-entry burst that runs the
   lean drain on the card: the micro-solve twin and the host-walk twin
   (``micro_solve = False``) in step, equal after every micro-drain
   (outcome, the admitted keys' admissions, every queue's heap and
   parked sets) and at every boundary, and a batch twin
   (``streaming=False``); (b) the ``wide`` fleet (multi-flavor and
   borrow-capable cohort ClusterQueues: the flavor-pick witness and the
   reserved-headroom walk on the host, the boundary drains on the card)
   at bench.py's 16 arrivals a tick for 400 ticks, stream and batch
   twins. Every twin's record (digests at each boundary with and
   without the QuotaReserved times, counts, time-to-admit p50 / p95,
   micro-solve entries) must equal the JAX package's pin, every stream
   twin's committed digests those of its batch twin, and every
   micro-solve must have run on the card. Each boundary drain prints its
   export mode, session frame, dirty rows and bytes written. (c)
   ``serve(stop)`` in a thread over a fresh ``single`` fleet with
   ``StreamingConfig(enabled=True, watch_driven=True)``: 8 bursts of
   128 and then 8 single arrivals injected from the main thread are all
   admitted, the watch
   worker's micro-drains run the lean drain on the card, the serve and
   worker threads stay alive until ``stop`` and are joined, and an
   exception in either fails the phase.

16. perf runner (Kueue's test/performance/scheduler runner, the
   port's ``perf.runner``): (a) ``Simulator(*generate(GeneratorConfig.
   baseline()))`` host only (15,000 arrivals on the virtual clock, fake
   runs, finishes that free quota, nothing cut): its SimStats record
   (admitted, finished, preemptions, cycles, simulated makespan,
   time-to-admission per class) and the committed-store digest with
   the QuotaReserved times must equal the JAX package's, and
   ``check(stats, BASELINE_SPEC)`` must report no violation; (b) the
   same at half its depth (7,500 workloads: cut for the script's
   time) with ``solver="auto"`` on the card, both routing cost
   EMAs reset before every routing decision (the wall-clock gate would
   route differently on every machine): the JAX ``solver="auto"`` record
   and
   device drain count, every drain re-checked by the native oracle with
   no plan fallback and no UnsupportedProblem or SolverUnavailable
   fallback; (c) ``drain_benchmark`` on Kueue's large-scale config
   without preemption (1,000 ClusterQueues, 50,000 workloads; after an
   untimed warm-up run on a 10-ClusterQueue store): the JAX plan's
   admissions, rounds and plan digest, with ``solve_seconds`` and
   ``cycle_ms`` printed.
17. what-if sweep (the port's ``sim``): (a) bench.py's whatif shape
   (bench.py:1465-1497, uncut: 128 scenarios over W = 160, C = 8)
   through ``solve_scenarios`` on the card, against
   ``solve_scenarios_sequential`` on the card with parity on all 128
   and the stacked plan's digest pinned to the JAX vmapped batch's;
   (b) ``WhatIfEngine(store).run(specs)`` on the baseline backlog
   (15,000 pending at t0) with an 8 x 4 quota x arrival grid and the
   default ``SimulatorConfig``: ``canonical_json()`` byte-identical to
   the JAX report's (sha256 pinned), 3 bucketed dispatches, parity on
   2. Per-dispatch walls and host reads are printed.
18. the relaxed LP arm (``solver/relax.py``, ``csrc/relax_lp.cu``): (a)
   ``cuda_relax.relax_lp`` against the plain ``relax.lp_loop`` run on
   the CPU (float ``index_add_`` on the card adds in any order), x bit
   for bit, at the LPs of phase 16 (c)'s large-scale backlog (W+1 =
   65,537, C = 1,000), of the what-if engine's baseline backlog (W+1 =
   16,385, C = 30) and of (d)'s 32 scenarios in one launch, at dense
   LPs of four and eight flavor-resource columns made from the first
   two (``scenarios.dense_relax_lp``) and at the first's backlog
   repeated four times (262,145 rows: every row array in global
   memory), with the cluster size and layout the host chose for each
   and CUDA event times of the kernel and (but for the last) of the
   plain loop on the card; the first two also at the other cluster
   sizes (1, 2 and 4 blocks), each bit for bit and timed; (b)
   ``relax.solve_relaxed`` on the card over phase 16 (c)'s backlog
   padded to a power of two (bench.py's ``relax_arm`` shape): the JAX
   record (support size and digest, repair rounds, admissions, plan
   digest, and ``plans_agree`` with phase 16 (c)'s exact plan, reused,
   not solved again), one relax_lp launch, ``lp_seconds`` and
   ``repair_seconds``; (c) bench.py's relax churn (bench.py:2053-2090) on
   its ``small`` shape (2 x 10 ClusterQueues): ``relax_force``, a host
   ``Scheduler`` attached, ``drain(verify=True)`` and 4 cycles of 32
   finishes and 32 arrivals, run with ``relax_audit_every = 1`` (every
   drain audited) and with 3 (the arm serves drains 2, 4 and 5 and
   commits its own plan; the served drain 2 syncs the exact arm's
   resident state, which the audited drain 3 solves on without an
   upload): the JAX record of each (served and audited counts, no
   oracle rejection, the committed-store digest), one relax_lp launch a
   drain; (d)
   ``sim.solve_scenarios_relax`` over the first 32 of phase 17 (a)'s 128
   scenarios (cut from 128 for the phase's time): every scenario's plan
   equals the JAX package's, one relax_lp launch for all 32. The relax
   pins are the JAX package's under tests/conftest.py's XLA flags
   (tests/torch_relax_pins.py). (a) also holds a dense LP of 40
   columns (above 32, where XLA sums the columns as a reduce-window
   of 32 and a reduce).
19. the FULL what-if sweep (the port's ``sim`` FULL path): (a)
   bench.py's fullsweep shape (bench.py:1552-1603: ``philly_trace(256,
   seed=11)``, capacity 0.25 of the demand, the earliest 40% admitted,
   the 6 x 7 quota x arrival grid cycled to 64 worlds, ``sweep_order``,
   ``full_caps``) through ``solve_scenarios_full`` in one dispatch and
   at a chunk width of 8: both equal the sequential FULL oracle on the
   card on all eight output fields for the first world of every width-8
   chunk, and the JAX package's record of all 64 (plan digest, rounds,
   admissions, preemptions); (b) ``solve_scenarios_tiered`` on (a)'s
   problem with ``LaneBudget(max_full_scenarios=32)``: rows 32-63
   re-tiered to the relax tier (``sweep_above_full_cap``), the FULL rows
   (a)'s, one relax_lp launch; and with a budget below one world: every
   row relax, one more launch; both the JAX records; (c)
   ``WhatIfEngine(store, config=SimulatorConfig(full_kernel=True),
   resident=True)`` on Kueue's baseline backlog at its full depth (15,000
   pending workloads, 5 x 6 ClusterQueues) over the first 4 worlds of
   phase 17 (b)'s grid (the base quota at arrival 1, 0.25, 0.5 and 0.75;
   at this depth a world with another quota ping-pongs towards the
   2 W1 + C + 5 round bound) with parity on 2, then 75 pending workloads
   (0.5%) removed and the 4 worlds again (a scatter sync), then again
   (a reuse): every report's canonical JSON, rounds, admissions,
   preemptions and tiers the JAX engine's, parity identical. Walls, rounds, host reads, chunk widths and the resident
   session's counters are printed. Pins: tests/torch_fullsweep_pins.py.

Phases 6-9 pin the JAX engine's plans without delta sessions, so they
run the port's engine with ``use_sessions = False``; phases 10-15 pin
them with sessions on. The relaxed arm's router decides by wall clock,
so phases 5 and 10-16 pin it off (``relax_off``) on both sides, and
relax_lp must not have launched before phase 18. Phases 8-11, 13 and
15-19 run no TAS flavor: the TAS kernels' launch counts are set to 0
before each drain (or each ``run_until_quiet``, each fleet of phase 15,
or each run of phases 16-19) and must still be 0 after it.

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
#: phase 4's depth: the first 1,500 workloads of the same draw hold all
#: 102 admissions of the full store, so the JAX plan (its engine,
#: ``mesh_mode="off"``) places the same batch in 66 rounds
STEPWISE_WORKLOADS = 1500
STEPWISE_REFERENCE = {**REFERENCE, "rounds": 66, "parked": 1398}
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
#: the JAX package's records of phases 11-13: its Scheduler over its
#: engine with ``mesh_mode="off"`` and sessions on, passed in as the
#: engine instance, per run_until_quiet (``JAX_PLATFORMS=cpu python
#: tests/torch_scheduler_pins.py`` prints them): host cycles, workloads
#: holding quota, evicted ones and their reasons, the committed-store
#: digest, device drains, UnsupportedProblem fallbacks and drain
#: admissions ("storm_host" is the solver=None twin)
SCHEDULER_REFERENCE = {
    "storm": [
        {"cycles": 1, "held": 600, "evicted": 0, "reasons": {},
         "digest": "e819d84a69107c8c51e19361167bad87"
                  "c0e0a1b93ad80eaaa5fe8bcb48ecfbad",
         "drains": 1, "unsupported": 0, "drain_admitted": 600},
        {"cycles": 1, "held": 30, "evicted": 600,
         "reasons": {"InClusterQueue": 600},
         "digest": "b85389d4099f2b5ca9b1883b4857873a"
                  "7119681d877d61e0b708e4fdc6df140e",
         "drains": 1, "unsupported": 0, "drain_admitted": 30},
    ],
    "storm_host": [
        {"cycles": 22, "held": 600, "evicted": 0, "reasons": {},
         "digest": "e819d84a69107c8c51e19361167bad87"
                  "c0e0a1b93ad80eaaa5fe8bcb48ecfbad"},
        {"cycles": 6, "held": 30, "evicted": 600,
         "reasons": {"InClusterQueue": 600},
         "digest": "b85389d4099f2b5ca9b1883b4857873a"
                  "7119681d877d61e0b708e4fdc6df140e"},
    ],
    "tas": {"cycles": 1, "held": 102, "evicted": 0, "reasons": {},
     "digest": "3c5c70649de0ccd9dc5e384b7fc66a88"
              "82f1868f16091678e5111eac2290bbe2",
     "drains": 1, "unsupported": 0, "drain_admitted": 102,
     "parked": 14898},
    "refused": [
        {"cycles": 22, "held": 600, "evicted": 0, "reasons": {},
         "digest": "aa72c45003b1ff0f3ec2a6c82310c5e1"
                  "918c7f4bd4b38f4770f430a2f5590cd5",
         "drains": 0, "unsupported": 1, "drain_admitted": 0},
        {"cycles": 8, "held": 30, "evicted": 600,
         "reasons": {"InClusterQueue": 600},
         "digest": "f6b272f309f3787467196d78b4f8fca8"
                  "81183ade689ebc131cf024399b48392e",
         "drains": 0, "unsupported": 2, "drain_admitted": 0},
    ],
}
#: the JAX package's records of phase 14 (its Scheduler as for phases
#: 11-13; ``TAS_MIXED_RUNS`` of tests/torch_scheduler_pins.py): per run
#: the record of phases 11-13 plus parked workloads, leader groups
#: holding quota and the host placement's ``_fill_in_counts`` calls
SCHEDULER_REFERENCE["tas_mixed"] = {
    "auto": {"cycles": 13, "held": 49, "evicted": 0, "reasons": {},
             "digest": "e093ff81bc614e9afde59f6305ee6879"
                       "52f22414eb22fa67f4384607cc599710",
             "drains": 1, "unsupported": 0, "drain_admitted": 49,
             "parked": 14951, "groups": 0, "fills": 90},
    "auto_fill": {"cycles": 13, "held": 49, "evicted": 0, "reasons": {},
                  "digest": "e093ff81bc614e9afde59f6305ee6879"
                            "52f22414eb22fa67f4384607cc599710",
                  "drains": 1, "unsupported": 0, "drain_admitted": 49,
                  "parked": 14951, "groups": 0, "fills": 90},
    "host_fill": {"cycles": 23, "held": 62, "evicted": 0, "reasons": {},
                  "digest": "f2e3562e733ee8685910b5f15d8cdf37"
                            "bffa8c49bd29b00274a543c28d9638f0",
                  "parked": 14938, "groups": 2, "fills": 385},
    "host": {"cycles": 23, "held": 62, "evicted": 0, "reasons": {},
             "digest": "f2e3562e733ee8685910b5f15d8cdf37"
                       "bffa8c49bd29b00274a543c28d9638f0",
             "parked": 14938, "groups": 2, "fills": 385},
}
#: phase 14's runs: (name, solver="auto", TASDeviceFillCounts on)
TAS_MIXED_RUNS = (("auto", True, False), ("auto_fill", True, True),
                  ("host_fill", False, True), ("host", False, False))
#: the JAX package's records of phase 15 (its Scheduler over a JAX
#: SolverEngine with mesh_mode="off"; ``JAX_PLATFORMS=cpu python
#: tests/torch_streaming_pins.py`` prints them): per twin the workloads,
#: those holding quota, the virtual time-to-admit p50 / p95 in ms, the
#: streamed admissions, the micro-solve entries and the micro-drains
#: that ran one, and at each boundary the timestamped and the committed
#: digests. The micro and host twins share their digests; every stream
#: twin shares the committed digests of its batch twin.
_SINGLE_STREAM = [
    "b2f632ecd256b58b2c0ca83b02c43007"
    "935a1e65dc9817b2070b27deb37b037f",
    "ce15f31856a3464457a5c50810e4c114"
    "58552b25b972a7d0a764124f3ee58051",
]
_SINGLE_BATCH = [
    "4d94d4cae0cea236f434f384fd7e2b98"
    "fb7548c0767107d3150b5ca23884a29d",
    "4e11743b25b592c38b2ae16e3c05e6f4"
    "cc0b5427cb9e765f56e8bfaac39928e7",
]
_SINGLE_COMMITTED = [
    "10d1699048ae4f43c35fb133b0cee789"
    "40fceb0900000f2c0e97b1a1704d921c",
    "ef94cb7ce0c7f387ae368836d931ca3f"
    "ad822d5879f8cc0d45b8a7abd4e20a23",
]
_WIDE_STREAM = [
    "5be2d5067b1eea8f3699d6dfef646ce3"
    "2a6f29003300103913b2b4e92ca07efd",
    "4dfa126ca4db123b04ddbc5377347930"
    "6f4354bb731eb7dc7b24976045f5aa98",
    "ce8126c2b327b5705e9dcfa0e63c4110"
    "d070b5538e94b38e4ed772b10f32673d",
    "b9092cb28bbff41e81db30afa118df03"
    "a252acd3469e339cb50b20d61811352d",
]
_WIDE_BATCH = [
    "d304913989fb272a04874ee455270f5a"
    "9081d91261674a9049c6a8ef23337036",
    "66777a97dcf4f81a3b68637324144fd9"
    "a6e5197e62e8c814e525f72186a0a1f2",
    "542871be6a9ab29ee73ee24560ff6377"
    "d6de3ca8cf33e9582cc93e304bdd8370",
    "77286cce5f730d056518fed4b30d8c77"
    "97786dd748962caef2348dadafe61b13",
]
_WIDE_COMMITTED = [
    "f75f8959f890c2c0b95395f766fa5e37"
    "eb5b2c339fe6484315626eddb54909d5",
    "906bc06cf6906b5c010e67cf9ab36757"
    "d9b94f597a2f976bc86d2be9d5b56d33",
    "e5531b8669c9f80763ee4e1009393cbf"
    "772ad0789a20cabfa29f763d2d89fffe",
    "edf831debbf5bfcfaa8a23fbd5d2c322"
    "837a643e41b7d50c9cad8b1044bf7995",
]
STREAMING_REFERENCE = {
    "single": {
        "micro": {
            "workloads": 25600, "admitted": 25600, "tta_ms_p50": 10.0,
            "tta_ms_p95": 10.0, "stream_admitted": 25344,
            "micro_entries": 25344, "micro_solves": 198,
            "boundaries": _SINGLE_STREAM, "committed": _SINGLE_COMMITTED},
        "host": {
            "workloads": 25600, "admitted": 25600, "tta_ms_p50": 10.0,
            "tta_ms_p95": 10.0, "stream_admitted": 25344, "micro_entries": 0,
            "micro_solves": 0, "boundaries": _SINGLE_STREAM,
            "committed": _SINGLE_COMMITTED},
        "batch": {
            "workloads": 25600, "admitted": 25600, "tta_ms_p50": 490.0,
            "tta_ms_p95": 940.0, "stream_admitted": 0, "micro_entries": 0,
            "micro_solves": 0, "boundaries": _SINGLE_BATCH,
            "committed": _SINGLE_COMMITTED},
    },
    "wide": {
        "stream": {
            "workloads": 6400, "admitted": 6400, "tta_ms_p50": 10.0,
            "tta_ms_p95": 10.0, "stream_admitted": 6336, "micro_entries": 0,
            "micro_solves": 0, "boundaries": _WIDE_STREAM,
            "committed": _WIDE_COMMITTED},
        "batch": {
            "workloads": 6400, "admitted": 6400, "tta_ms_p50": 490.0,
            "tta_ms_p95": 940.0, "stream_admitted": 0, "micro_entries": 0,
            "micro_solves": 0, "boundaries": _WIDE_BATCH,
            "committed": _WIDE_COMMITTED},
    },
}
#: phase 15's fleets: (arrivals a tick, ticks, twins), as
#: tests/torch_streaming_pins.py's STREAMING_RUNS
STREAMING_RUNS = {"single": (128, 200, ("micro", "host", "batch")),
                  "wide": (16, 400, ("stream", "batch"))}
#: the JAX package's records of phases 16-17 (``JAX_PLATFORMS=cpu python
#: tests/torch_sim_pins.py``): its Simulator host-only and with
#: solver="auto" over a mesh_mode="off" engine, both cost EMAs reset
#: before every routing decision (auto at PERF_AUTO_SCALE of the depth);
#: drain_benchmark's plan; the vmapped batch of bench.py's whatif shape;
#: the WhatIfEngine report
SIM_REFERENCE = {
    "host": {"admitted": 15000, "finished": 15000, "preemptions": 5850,
             "cycles": 1490, "sim_wall_ms": 75900,
             "tta_ms_by_class": {"large": 0.0,
                                 "medium": 26148.474576271186,
                                 "small": 55434.28571428572},
             "digest": ("d936867412ec4e7d89395d8625abfa13"
                        "90e453a84bfca3fc4fd197de47c0de90")},
    "auto": {"admitted": 7500, "finished": 7500, "preemptions": 2850,
             "cycles": 421, "sim_wall_ms": 37800,
             "tta_ms_by_class": {"large": 0.0,
                                 "medium": 13188.275862068966,
                                 "small": 27060.0},
             "digest": ("d3953aef3a5aac1711ff552cadff2040"
                        "4f3535fdab6c01d90755e3d687adedee"),
             "drains": 45, "unsupported": 0, "drain_admitted": 8370},
}
DRAIN_LARGE_REFERENCE = {
    "workloads": 50000, "cluster_queues": 1000, "admitted": 1000,
    "rounds": 51,
    "plan_digest": "90acdd4444669bb1cfa1c4b05ad2d74e"
                   "28ba9b1110e36ca8bbd782dde32d877b"}
WHATIF_BENCH_REFERENCE = {
    "scenarios": 128, "max_rounds": 22, "rounds_sum": 2520,
    "admitted_sum": 2216,
    "plan_digest": "864e4c900936b008c372d1b00ed5e7e3"
                   "529fd1d4008545da6cb490ccdc72a6f3"}
WHATIF_BASELINE_REFERENCE = {
    "canonical_sha256": "7dac59809a2a1d74577912d681379044"
                        "bce295427125582748089d5201a8c9ae",
    "max_rounds": 503, "rounds_sum": 10068, "admitted_sum": 6940,
    "parity": {"checked": 2, "identical": True, "mismatches": []},
    "batch_dispatches": 3,
    "round_buckets": {"128": 8, "256": 8, "512": 16}}
#: the JAX package's records of phase 18 (``JAX_PLATFORMS=cpu python
#: tests/torch_relax_pins.py``, under tests/conftest.py's XLA flags):
#: solve_relaxed on the padded large-scale backlog, bench.py's relax churn
#: on its small shape, and the relax tier over 32 whatif scenarios
RELAX_REFERENCE = {
    "relax_arm": {
        "live": 50000, "support": 7000, "support_padded": 8191,
        "support_digest": ("d0565339883328a4c947079e42ed76c8"
                           "15234c990007c1cc961fb79d940f32e9"),
        "repair_rounds": 8, "admitted": 1000,
        "plan_digest": ("6808dafc609e9892547114ac1e841156"
                        "78c828277b812e01b7ea0907ba064521"),
        "plans_agree": True},
    "churn": {
        "drains": 5, "admitted": [20, 20, 20, 20, 80],
        "audit_match": 5, "audit_diverged": 0, "served": 0, "error": 0,
        "oracle_rejections": 0,
        "digest": ("a3850886ee3fd9e3ee01c3586d9bc514"
                   "f18904b272487da7e76cb29c611b3e78")},
    "churn_served": {
        "drains": 5, "admitted": [20, 20, 20, 20, 80],
        "audit_match": 2, "audit_diverged": 0, "served": 3, "error": 0,
        "oracle_rejections": 0,
        "digest": ("a3850886ee3fd9e3ee01c3586d9bc514"
                   "f18904b272487da7e76cb29c611b3e78")},
    "relax_tier": {
        "scenarios": 32,
        "plan_digest": ("9dc3f1901eb1e21dd4e6f95521fa23ff"
                        "9c2b1139f270176fb81db9c36b9252d0"),
        "admitted": [8] * 8 + [2] * 8 + [4] * 8 + [6] * 8,
        "rounds": [7] * 10 + [6] + [7] * 14 + [8, 8] + [7] * 5},
}
#: phase 17's grids: bench.py's whatif sweep, and (b)'s 8 x 4 worlds
BENCH_QUOTA = (0.25, 0.5, 0.75, 1.25, 1.5, 2.0, 3.0)
BENCH_ARRIVAL = (0.5, 0.75, 1.25, 1.5, 2.0, 2.5, 3.0)
WHATIF_QUOTA = (0.25, 0.5, 0.75, 1.25, 1.5, 2.0, 3.0)
WHATIF_ARRIVAL = (0.25, 0.5, 0.75)
#: phase 16 (b)'s depth: the baseline's per-class counts times this
#: (7,500 workloads; cut from 15,000 for the script's time)
PERF_AUTO_SCALE = 0.5
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


def _fill_vec(rng, R, leader, slice_size, slice_level):
    """A fill's int32 request vector [per_pod R][leader R][has_leader]
    [slice_size][slice_level]."""
    import numpy as np

    return np.concatenate([
        rng.integers(0, 4, size=R).astype(np.int32),
        (rng.integers(0, 3, size=R) * leader).astype(np.int32),
        np.asarray([leader, slice_size, slice_level], np.int32)])


def _fill_work(tree, R: int) -> tuple[int, int]:
    """Bytes and integer operations of fill_counts: the capacity, the
    parents and the request vector read once, the [5, N] states written
    once; per leaf the leaf pass (compare, divide, min per element,
    twice), per domain its share of the roll-up."""
    D, N = tree.n_leaves, tree.n_domains
    nbytes = 4 * (D * R + N + 2 * R + 3 + 5 * N)
    return nbytes, 8 * D * R + 12 * N


def _check_fill(name, tree, cap, vec) -> int:
    """fill_counts against its plain version on one tree, exactly;
    returns the max abs error (0)."""
    import torch

    from kueue_oss_tpu_torch.solver import cuda_tas

    leaf_before = cuda_tas.leaf_states.launches
    got = cuda_tas.fill_counts(tree, cap, vec)
    want = cuda_tas.fill_counts_reference(tree, cap, vec)
    torch.cuda.synchronize()
    if cuda_tas.leaf_states.launches != leaf_before:
        raise AssertionError("the plain fill launched leaf_states")
    err = (int((got.long() - want.long()).abs().max())
           if got.shape == want.shape else -1)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"fill_counts differs from the plain version "
                             f"on case {name!r} (max abs err {err})")
    return err


def check_fill_counts(device) -> dict:
    """Phase 3 for ``fill_counts``: exact agreement at phase 14's fill
    shape (the 1 x 10 x 64 tree, R = 2), on a seeded tree with slices
    and a leader at every slice level, on random 1-4 level trees and on
    a tree whose states exceed shared memory; then CUDA-event times of
    kernel and plain version at phase 14's shape."""
    import numpy as np
    import torch

    from kueue_oss_tpu_torch import scenarios as sc
    from kueue_oss_tpu_torch.solver import cuda_tas

    rng = np.random.default_rng(14)
    cases = []
    parents, cap, _ = sc.drain_placer_batch(1)
    fill_tree = cuda_tas.PlacerTree(parents)
    cap = rng.integers(0, 96_001, size=(cap.shape[0], 2)).astype(np.int32)
    main = (fill_tree, cap, np.concatenate([
        np.asarray([1000, 1, 0, 0], np.int32),
        np.asarray([0, 1, 2], np.int32)]))
    cases.append(("phase 14 fill 1x10x64 R=2",) + main)
    for level in range(3):
        for leader in (0, 1):
            cases.append((f"1x10x64 slices at level {level} "
                          f"leader={leader}", fill_tree, cap,
                          _fill_vec(rng, 2, leader, 2, level)))
    for n_levels in (1, 2, 3, 4):
        for seed in range(2):
            parents, rcap = sc.random_placer_tree(
                n_levels, seed, min_children=seed % 2,
                max_children=(4, 40)[seed])
            rcap[rng.random(rcap.shape[0]) < 0.2] = 0
            cases.append((f"random L={n_levels} seed={seed}",
                          cuda_tas.PlacerTree(parents), rcap,
                          _fill_vec(rng, rcap.shape[1], seed,
                                    int(rng.integers(1, 4)),
                                    int(rng.integers(0, n_levels)))))
    parents, big, _ = sc.drain_placer_batch(1, n_racks=200, n_hosts=64)
    big_tree = cuda_tas.PlacerTree(parents)
    if big_tree.fill_uses_shared():
        raise AssertionError("1x200x64: the fill's state fits in shared "
                             "memory")
    cases.append(("1x200x64 state in global memory", big_tree,
                  rng.integers(0, 200, size=big.shape).astype(np.int32),
                  _fill_vec(rng, 2, 1, 2, 1)))
    max_err = 0
    for name, tree, c, v in cases:
        max_err = max(max_err, _check_fill(
            name, tree, torch.as_tensor(c, device=device),
            torch.as_tensor(v, device=device)))
    print(f"[kernel] fill_counts == fill_counts_reference exactly on "
          f"{len(cases)} cases: " + "; ".join(c[0] for c in cases))
    tree, c, v = main
    c = torch.as_tensor(c, device=device)
    v = torch.as_tensor(v, device=device)
    ms = _time_ms(lambda: cuda_tas.fill_counts(tree, c, v))
    plain_ms = _time_ms(lambda: cuda_tas.fill_counts_reference(tree, c, v),
                        iters=50, warmup=5)
    nbytes, nops = _fill_work(tree, 2)
    return {"name": "fill_counts", "route": "cuda",
            "source": "kueue_oss_tpu_torch/csrc/fill_counts.cu",
            "replaces": "kueue_oss_tpu/solver/pallas_tas.py:99 (with the "
                        "roll-up of kueue_oss_tpu/solver/tas_kernels.py:"
                        "289-344 fill_counts_ext)",
            "max_abs_err": max_err, "shape": [tree.n_domains, 2],
            "ms": ms, "plain_ms": plain_ms, **_bound(nbytes, nops),
            "library_ms": None}


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


def check_plan(store, queues, result, reference=REFERENCE) -> None:
    """The JAX reference plan plus independent capacity/quota checks."""
    from kueue_oss_tpu_torch.scenarios import plan_digest

    parked = sum(len(q.inadmissible) for q in queues.queues.values())
    got = {"admitted": result.admitted, "rounds": result.rounds,
           "evicted": result.evicted, "parked": parked,
           "digest": plan_digest(store, result.admitted_keys)}
    if got != reference:
        raise AssertionError(f"plan {got} != reference {reference}")

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


def _drain_store(n_workloads: int = 15000):
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import tas_drain_store

    store = tas_drain_store(types, Store, n_workloads=n_workloads)
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

    store, queues = _drain_store(STEPWISE_WORKLOADS)
    engine = SolverEngine(store, queues)
    engine._tas_placer = StepwisePlacer(engine.device)
    before = cuda_tas.leaf_states.launches
    _settle()
    t0 = time.monotonic()
    result = engine.drain(now=0.0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check_plan(store, queues, result, STEPWISE_REFERENCE)
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
    _victim_checks(store, result.admitted_keys, result.evicted_keys, before)
    return got


def _victim_checks(store, admitted_keys, evicted_keys, before) -> None:
    """The quota checks, and the victims' independent checks: the
    evicted keys are exactly the workloads whose QuotaReserved flipped
    to false, and each is below a preemptor of its own ClusterQueue in
    priority or was admitted in a borrowing one."""
    _quota_checks(store)
    reserved0, cq_of, cq_used0 = before
    flipped = {k for k in reserved0
               if not store.workloads[k].is_quota_reserved}
    if (len(evicted_keys) != len(set(evicted_keys))
            or set(evicted_keys) != flipped):
        raise AssertionError("evicted_keys differ from the workloads whose "
                             "QuotaReserved flipped to false")
    nominal = {name: spec.resource_groups[0].flavors[0].resources[0].nominal
               for name, spec in store.cluster_queues.items()}
    preemptor_prio: dict[str, int] = {}
    for key in admitted_keys:
        wl = store.workloads[key]
        cq = wl.status.admission.cluster_queue
        preemptor_prio[cq] = max(preemptor_prio.get(cq, wl.priority),
                                 wl.priority)
    for key in evicted_keys:
        wl = store.workloads[key]
        cq = cq_of[key]
        own = preemptor_prio.get(cq)
        borrowing = cq_used0.get(cq, 0) > nominal[cq]
        if not ((own is not None and wl.priority < own) or borrowing):
            raise AssertionError(f"victim {key} of {cq} is neither below a "
                                 f"preemptor of its ClusterQueue nor "
                                 f"admitted in a borrowing one")


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
        _reset_launches()
        _settle()
        t0 = time.monotonic()
        result = engine.drain(now=now)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if _launches():
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
    _reset_launches()
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
            or _launches() != 1):
        raise AssertionError(
            f"TAS FULL path: {launches} tas_place_sequential launches "
            f"({steps} steps), {cuda_tas.leaf_states.launches} leaf_states "
            f"and {cuda_tas.launch_counts['fill_counts']} fill_counts "
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
          f"and 0 fill_counts launches; FULL drain counters " + json.dumps(_stats(result)))
    return ({"drain_s": wall,
             **{f"{k}_s": v for k, v in result.phases.items()},
             **_stats(result)}, launches)


def _reset_launches() -> None:
    from kueue_oss_tpu_torch.solver import cuda_tas

    cuda_tas.leaf_states.launches = 0
    cuda_tas.tas_place_sequential.launches = 0
    cuda_tas.reset_counts()


def _launches() -> int:
    from kueue_oss_tpu_torch.solver import cuda_tas

    return (cuda_tas.leaf_states.launches
            + cuda_tas.tas_place_sequential.launches
            + cuda_tas.launch_counts["fill_counts"])


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
        engine = relax_off(SolverEngine(store, queues))
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


def committed_store_digest(store) -> str:
    """sha256 over the sorted workload keys of each workload's
    QuotaReserved and Admitted status, its admission (ClusterQueue, and
    per podset the flavors, count, resource usage and topology
    assignment), its Evicted and Preempted conditions (status, reason)
    and its requeue state (the copy of
    tests/torch_scheduler_pins.py's, held to it by the tests)."""
    import hashlib

    rows = []
    for key in sorted(store.workloads):
        wl = store.workloads[key]
        adm = wl.status.admission
        row = [key, wl.is_quota_reserved, wl.is_admitted]
        if adm is None:
            row.append(None)
        else:
            podsets = []
            for psa in adm.podset_assignments:
                ta = psa.topology_assignment
                podsets.append([
                    psa.name, sorted(psa.flavors.items()), psa.count,
                    sorted(psa.resource_usage.items()),
                    None if ta is None else
                    [list(ta.levels),
                     [[list(d.values), d.count] for d in ta.domains]]])
            row.append([adm.cluster_queue, podsets])
        for ctype in ("Evicted", "Preempted"):
            c = wl.status.conditions.get(ctype)
            row.append(None if c is None else [c.status, c.reason])
        rs = wl.status.requeue_state
        row.append(None if rs is None else [rs.count, rs.requeue_at])
        rows.append(row)
    return hashlib.sha256(json.dumps(
        rows, separators=(",", ":")).encode()).hexdigest()


def _scheduler_record(store, sched, cycles, before_counts) -> dict:
    """A run_until_quiet's record in the form SCHEDULER_REFERENCE pins
    it: host cycles, held / evicted workloads and the evicted ones'
    reasons, the digest, and the device drains, UnsupportedProblem
    fallbacks and drain admissions since ``before_counts``."""
    evicted = [w for w in store.workloads.values() if w.is_evicted]
    rec = {"cycles": cycles,
           "held": sum(1 for w in store.workloads.values()
                       if w.is_quota_reserved),
           "evicted": len(evicted),
           "reasons": dict(sorted(collections.Counter(
               w.status.conditions["Preempted"].reason for w in evicted
               if "Preempted" in w.status.conditions).items())),
           "digest": committed_store_digest(store)}
    if before_counts is not None:
        c = sched.solver_counts
        rec.update(drains=c["drains"] - before_counts["drains"],
                   unsupported=(c["unsupported"]
                                - before_counts["unsupported"]),
                   drain_admitted=c["admitted"] - before_counts["admitted"])
    return rec


def _run_quiet(store, sched, wave, now):
    """Add a wave and run ``run_until_quiet(now, tick=0.001)`` timed;
    returns (record, wall seconds, reserved state before, oracle
    counters, scheduler counts before)."""
    import torch

    from kueue_oss_tpu_torch import native

    for wl in wave:
        store.add_workload(wl)
    before = _reserved_state(store)
    counts0 = (dict(sched.solver_counts) if sched.solver is not None
               else None)
    native.reset_counters()
    _reset_launches()
    _settle()
    t0 = time.monotonic()
    cycles = sched.run_until_quiet(now=now, tick=0.001)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    rec = _scheduler_record(store, sched, cycles, counts0)
    return rec, wall, before, dict(native.counters), counts0


def _wave_keys(store, before):
    """The keys admitted and evicted since ``before``."""
    reserved0 = before[0]
    admitted = [k for k, w in store.workloads.items()
                if w.is_quota_reserved and not w.is_finished
                and k not in reserved0]
    evicted = [k for k in reserved0
               if not store.workloads[k].is_quota_reserved]
    return admitted, evicted


def scheduler_storm() -> tuple:
    """Phase 11: the baseline storm through Scheduler(solver="auto")
    and a host-only twin. Returns (report, TAS kernel launches)."""
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import baseline_preempt_store
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler

    store, wave1, wave2 = baseline_preempt_store(types, Store)
    sched = Scheduler(store, QueueManager(store), solver="auto")
    relax_off(sched._solver_engine())
    twin_store, twin1, twin2 = baseline_preempt_store(types, Store)
    twin = Scheduler(twin_store, QueueManager(twin_store))
    out, launches = {}, 0
    for i, (label, now, wave, twin_wave) in enumerate((
            ("wave1", 100.0, wave1, twin1),
            ("wave2", 200.0, wave2, twin2))):
        rec, wall, before, oracle, _ = _run_quiet(store, sched, wave, now)
        launches += _launches()
        want = SCHEDULER_REFERENCE["storm"][i]
        if rec != want:
            raise AssertionError(f"scheduler storm {label}: {rec} != "
                                 f"reference {want}")
        drain = sched.last_drain
        c = sched.solver_counts
        if (rec["drains"] != 1 or oracle["native_calls"] != 1
                or oracle["python_calls"] or oracle["rejections"]
                or oracle["entries"] != drain.verified
                or drain.verified != drain.admitted
                or drain.plan_fallbacks or c["plan_fallbacks"]
                or c["unsupported"] or c["unavailable"] or _launches()):
            raise AssertionError(
                f"scheduler storm {label}: oracle {oracle}, counts {c}, "
                f"drain verified {drain.verified} of {drain.admitted} "
                f"admitted, {_launches()} TAS launches")
        admitted, evicted = _wave_keys(store, before)
        _victim_checks(store, admitted, evicted, before)
        twin_rec, twin_wall, twin_before, _, _ = _run_quiet(
            twin_store, twin, twin_wave, now)
        want_twin = SCHEDULER_REFERENCE["storm_host"][i]
        if twin_rec != want_twin or twin_rec["digest"] != rec["digest"]:
            raise AssertionError(f"host-only twin {label}: {twin_rec} != "
                                 f"reference {want_twin}")
        t_adm, t_ev = _wave_keys(twin_store, twin_before)
        _victim_checks(twin_store, t_adm, t_ev, twin_before)
        out[label] = {
            "wall_s": wall, "cycles": rec["cycles"],
            "drain": {f"{k}_s": v for k, v in drain.phases.items()},
            "drain_rounds": drain.rounds, "verified": drain.verified,
            "oracle_s": oracle["seconds"],
            "host_only": {"wall_s": twin_wall,
                          "cycles": twin_rec["cycles"]}}
        print(f"[scheduler storm {label}] matches the reference "
              f"({rec['held']} held, {rec['evicted']} evicted "
              f"{rec['reasons']}; {rec['drains']} drain, {rec['cycles']} "
              f"host cycle); oracle native on {oracle['entries']} entries, "
              f"0 rejected; host-only twin {twin_rec['cycles']} cycles, "
              f"same store; " + json.dumps(out[label]))
    return out, launches


def scheduler_tas() -> tuple:
    """Phase 12: the full-size TAS store through
    Scheduler(solver="auto"). Returns (report, tas_place_sequential
    launches, leaf_states launches)."""
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import plan_digest, tas_drain_store
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_oss_tpu_torch.solver import cuda_tas

    store = tas_drain_store(types, Store)
    sched = Scheduler(store, QueueManager(store), solver="auto")
    relax_off(sched._solver_engine())
    cuda_tas.tas_place_sequential.steps = 0
    rec, wall, _, oracle, _ = _run_quiet(store, sched, [], 0.0)
    launches = cuda_tas.tas_place_sequential.launches
    leaf_launches = cuda_tas.leaf_states.launches
    fill_launches = cuda_tas.launch_counts["fill_counts"]
    steps = cuda_tas.tas_place_sequential.steps
    rec["parked"] = sum(len(q.inadmissible)
                        for q in sched.queues.queues.values())
    want = SCHEDULER_REFERENCE["tas"]
    if rec != want:
        raise AssertionError(f"scheduler TAS: {rec} != reference {want}")
    drain = sched.last_drain
    if (launches != 1 or steps != REFERENCE["admitted"] or leaf_launches
            or fill_launches
            or plan_digest(store, drain.admitted_keys) != REFERENCE["digest"]
            or drain.rounds != REFERENCE["rounds"]
            or rec["parked"] != REFERENCE["parked"]
            or oracle["python_calls"] or oracle["rejections"]
            or oracle["entries"] != drain.admitted):
        raise AssertionError(
            f"scheduler TAS: {launches} tas_place_sequential launches "
            f"({steps} steps), {leaf_launches} leaf_states and "
            f"{fill_launches} fill_counts launches, oracle {oracle}, "
            f"drain rounds {drain.rounds}")
    _quota_checks(store)
    out = {"wall_s": wall, "cycles": rec["cycles"],
           "drain": {f"{k}_s": v for k, v in drain.phases.items()},
           "oracle_s": oracle["seconds"]}
    print(f"[scheduler tas] matches the reference ({rec['held']} held, "
          f"{rec['parked']} parked, phase 5's plan digest); 1 "
          f"tas_place_sequential launch, {steps} steps, 0 leaf_states "
          f"and 0 fill_counts launches; no host TAS head; " + json.dumps(out))
    return out, launches, leaf_launches


def scheduler_refused() -> tuple:
    """Phase 13: the storm with memory in bytes, refused at export by
    every drain, admitted by host cycles. Returns (report, TAS kernel
    launches)."""
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import refused_quantity_store
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler

    store, wave1, wave2 = refused_quantity_store(types, Store)
    sched = Scheduler(store, QueueManager(store), solver="auto")
    relax_off(sched._solver_engine())
    out, launches = {}, 0
    for i, (label, now, wave) in enumerate((("wave1", 100.0, wave1),
                                             ("wave2", 200.0, wave2))):
        rec, wall, before, oracle, _ = _run_quiet(store, sched, wave, now)
        launches += _launches()
        want = SCHEDULER_REFERENCE["refused"][i]
        if rec != want:
            raise AssertionError(f"scheduler refused {label}: {rec} != "
                                 f"reference {want}")
        if (rec["drains"] or rec["drain_admitted"] or oracle["entries"]
                or not rec["unsupported"] or _launches()):
            raise AssertionError(f"scheduler refused {label}: {rec}, "
                                 f"oracle {oracle}")
        admitted, evicted = _wave_keys(store, before)
        _victim_checks(store, admitted, evicted, before)
        out[label] = {"wall_s": wall, "cycles": rec["cycles"],
                      "unsupported": rec["unsupported"]}
        print(f"[scheduler refused {label}] matches the reference "
              f"({rec['held']} held, {rec['evicted']} evicted; "
              f"{rec['unsupported']} UnsupportedProblem fallbacks, 0 "
              f"drains, {rec['cycles']} host cycles); " + json.dumps(
                  out[label]))
    return out, launches


def _checked_device_fill(fill, acc: dict):
    """``TASFlavorSnapshot._device_fill`` that, after the device fill,
    recomputes every domain's five states with the host path (the leaf
    division of ``_fill_in_counts`` and ``_roll_up``) from the same
    leaves and raises on any difference. ``acc`` sums seconds: "fill_s"
    the device fill (its host work, upload, launch and read-back),
    "rollup_s" the host path's division and roll-up of the same leaves,
    "check_s" the whole check."""
    from kueue_oss_tpu_torch.tas.snapshot import count_in

    def checked(self, req, leader_req, slice_size, slice_level_idx,
                stats):
        _, per_level = self._device_tree_arrays()
        remaining = [leaf._remaining for leaf in per_level[-1]]
        t0 = time.perf_counter()
        fill(self, req, leader_req, slice_size, slice_level_idx, stats)
        acc["fill_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        fields = ("state", "state_with_leader", "leader_state",
                  "slice_state", "slice_state_with_leader")
        got = [[getattr(d, f) for f in fields]
               for doms in per_level for d in doms]
        for dom in self.domains.values():
            for f in fields:
                setattr(dom, f, 0)
        t1 = time.perf_counter()
        for leaf, rem in zip(per_level[-1], remaining):
            if rem is None:
                continue  # filtered out
            rem = dict(rem)
            leaf.state = count_in(req, rem)
            if leader_req is not None and count_in(leader_req, rem) > 0:
                leaf.leader_state = 1
                for r, q in leader_req.items():
                    rem[r] = rem.get(r, 0) - q
            leaf.state_with_leader = count_in(req, rem)
        for root in self.roots.values():
            self._roll_up(root, slice_size, slice_level_idx, 0,
                          leader_req is not None)
        acc["rollup_s"] += time.perf_counter() - t1
        want = [[getattr(d, f) for f in fields]
                for doms in per_level for d in doms]
        if got != want:
            bad = next(i for i, (g, w) in enumerate(zip(got, want))
                       if g != w)
            raise AssertionError(
                f"device fill differs from the host roll-up at domain "
                f"{bad}: {got[bad]} != {want[bad]}")
        acc["check_s"] += time.perf_counter() - t0

    return checked


def _topology_checks(store) -> int:
    """Phase 14's independent checks on every workload holding quota:
    its podsets' domains place exactly their counts; no node holds more
    than its allocatable (cpu and pods); a required-rack podset, and a
    leader group as a whole, sits in one rack; every slice lies whole
    in its slice domain. Returns the podsets checked."""
    from kueue_oss_tpu_torch.scenarios import BLOCK, HOSTNAME, RACK

    node_use: dict[str, dict] = {}
    checked = 0
    for key, wl in store.workloads.items():
        if not wl.is_quota_reserved:
            continue
        podsets = {ps.name: ps for ps in wl.podsets}
        group_racks: dict[str, set] = {}
        for psa in wl.status.admission.podset_assignments:
            ps = podsets[psa.name]
            ta = psa.topology_assignment
            if ta is None or sum(d.count for d in ta.domains) != psa.count:
                raise AssertionError(f"{key}/{psa.name}: {ta} does not "
                                     f"place its {psa.count} pods")
            tr = ps.topology_request
            racks = set()
            per_slice_domain: dict[str, int] = {}
            for d in ta.domains:
                node = store.nodes[d.values[-1]]
                use = node_use.setdefault(node.name, {"pods": 0})
                use["pods"] += d.count
                for r, q in ps.requests.items():
                    use[r] = use.get(r, 0) + q * d.count
                racks.add(node.labels[RACK])
                if tr.podset_slice_required_topology is not None:
                    dom = {RACK: node.labels[RACK], HOSTNAME: node.name,
                           BLOCK: node.labels[BLOCK]}[
                               tr.podset_slice_required_topology]
                    per_slice_domain[dom] = (per_slice_domain.get(dom, 0)
                                             + d.count)
            if tr.required == RACK and len(racks) != 1:
                raise AssertionError(f"{key}/{psa.name}: required rack, "
                                     f"placed on racks {sorted(racks)}")
            if any(n % tr.podset_slice_size
                   for n in per_slice_domain.values()):
                raise AssertionError(f"{key}/{psa.name}: slices of "
                                     f"{tr.podset_slice_size} split: "
                                     f"{per_slice_domain}")
            if tr.podset_group_name:
                group_racks.setdefault(tr.podset_group_name, set()).update(
                    racks)
            checked += 1
        for group, racks in group_racks.items():
            if len(racks) != 1:
                raise AssertionError(f"{key}: group {group} spans racks "
                                     f"{sorted(racks)}")
    for name, use in node_use.items():
        alloc = store.nodes[name].allocatable
        if any(q > alloc.get(r, 0) for r, q in use.items()):
            raise AssertionError(f"node {name} over its allocatable: "
                                 f"{use} > {alloc}")
    return checked


def scheduler_tas_host() -> tuple:
    """Phase 14: the mixed TAS store through the scheduler in four runs.
    Returns (report, fill_counts launches, leaf_states launches,
    tas_place_sequential launches)."""
    import torch

    from kueue_oss_tpu_torch import features
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import tas_mixed_store
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_oss_tpu_torch.solver import cuda_tas
    from kueue_oss_tpu_torch.tas.snapshot import TASFlavorSnapshot

    fill_in_counts = TASFlavorSnapshot._fill_in_counts
    device_fill = TASFlavorSnapshot._device_fill
    fill_counts = cuda_tas.fill_counts
    calls = [0]
    acc = {}
    tiles = []

    def counted(self, *args, **kw):
        calls[0] += 1
        return fill_in_counts(self, *args, **kw)

    def kept(tree, leaf_capacity, vec):
        if not tiles:
            tiles.append((tree, leaf_capacity, vec))
        return fill_counts(tree, leaf_capacity, vec)

    out = {}
    fill_total = leaf_total = place_total = 0
    TASFlavorSnapshot._fill_in_counts = counted
    TASFlavorSnapshot._device_fill = _checked_device_fill(device_fill,
                                                          acc)
    cuda_tas.fill_counts = kept
    try:
        for name, solver, fill in TAS_MIXED_RUNS:
            store = tas_mixed_store(types, Store)
            sched = Scheduler(store, QueueManager(store),
                              solver="auto" if solver else None,
                              device="cuda")
            if solver:
                relax_off(sched._solver_engine())
            features.set_gates({"TASDeviceFillCounts": fill})
            calls[0] = 0
            acc.update(check_s=0.0, fill_s=0.0, rollup_s=0.0)
            counts0 = dict(sched.solver_counts) if solver else None
            _reset_launches()
            _settle()
            t0 = time.monotonic()
            cycles = sched.run_until_quiet(now=100.0, tick=0.001)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            features.reset()
            fills = cuda_tas.launch_counts["fill_counts"]
            leaf = cuda_tas.leaf_states.launches
            place = cuda_tas.tas_place_sequential.launches
            rec = _scheduler_record(store, sched, cycles, counts0)
            rec["parked"] = sum(len(q.inadmissible)
                                for q in sched.queues.queues.values())
            rec["groups"] = sum(1 for w in store.workloads.values()
                                if w.is_quota_reserved
                                and len(w.podsets) == 2)
            rec["fills"] = calls[0]
            want = SCHEDULER_REFERENCE["tas_mixed"][name]
            if rec != want:
                raise AssertionError(f"scheduler TAS host {name}: {rec} != "
                                     f"reference {want}")
            if (fills != (rec["fills"] if fill else 0) or leaf != 0
                    or place != (rec["drains"] if solver else 0)):
                raise AssertionError(
                    f"scheduler TAS host {name}: {fills} fill_counts and "
                    f"{leaf} leaf_states launches for {rec['fills']} "
                    f"fills, {place} tas_place_sequential launches")
            checked = _topology_checks(store)
            _quota_checks(store)
            fill_total += fills
            leaf_total += leaf
            place_total += place
            out[name] = {"wall_s": wall, "cycles": cycles,
                         "fills": rec["fills"], "fill_counts": fills,
                         "leaf_states": leaf,
                         "tas_place_sequential": place,
                         "fill_check_s": acc["check_s"],
                         "podsets_checked": checked}
            if fill:
                # per fill, on the same leaves in the same run: the device
                # fill, and the host division and roll-up it replaces
                out[name]["fill_ms"] = acc["fill_s"] / calls[0] * 1e3
                out[name]["host_rollup_ms"] = (acc["rollup_s"] / calls[0]
                                               * 1e3)
            if solver:
                out[name]["drain"] = {
                    f"{k}_s": v for k, v in sched.last_drain.phases.items()}
            print(f"[scheduler tas host {name}] matches the reference "
                  f"({rec['held']} held, {rec['groups']} leader groups, "
                  f"{rec['parked']} parked, {rec['fills']} fills); "
                  + json.dumps(out[name]))
    finally:
        TASFlavorSnapshot._fill_in_counts = fill_in_counts
        TASFlavorSnapshot._device_fill = device_fill
        cuda_tas.fill_counts = fill_counts
        features.reset()
    # the device fill's cost over the host roll-up, per fill: timed
    # around each fill of (c) against the host division and roll-up of
    # the same leaves
    c = out["host_fill"]
    out["fill_over_rollup_ms"] = c["fill_ms"] - c["host_rollup_ms"]
    # one fill's tile, kernel against plain (launches made here to
    # compare and time are not counted above), and the leaf pass alone
    # at the same tile
    tree, cap, vec = tiles[0]
    got = cuda_tas.fill_counts(tree, cap, vec)
    want = cuda_tas.fill_counts_reference(tree, cap, vec)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("fill_counts at the fill's tile differs from "
                             "the plain version")
    D, R = cap.shape
    nbytes, nops = _fill_work(tree, R)
    tile = {"shape": [tree.n_domains, R], "max_abs_err": 0,
            "ms": _time_ms(lambda: cuda_tas.fill_counts(tree, cap, vec)),
            "plain_ms": _time_ms(lambda: cuda_tas.fill_counts_reference(
                tree, cap, vec), iters=50, warmup=5),
            **_bound(nbytes, nops)}
    out["fill_tile"] = tile
    per_pod, leader, flag = vec[:R], vec[R:2 * R], vec[2 * R] > 0
    got = cuda_tas.leaf_states(cap, per_pod, leader, flag)
    want = cuda_tas.leaf_states_reference(cap, per_pod, leader, flag)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    if err:
        raise AssertionError(f"leaf_states at the fill's tile: max abs "
                             f"err {err}")
    leaf_tile = {"shape": [D, R], "max_abs_err": err,
                 "ms": _time_ms(lambda: cuda_tas.leaf_states(
                     cap, per_pod, leader, flag)),
                 "plain_ms": _time_ms(lambda: cuda_tas.leaf_states_reference(
                     cap, per_pod, leader, flag)),
                 **_bound(4 * (D * R + 2 * R + 1 + 3 * D), 8 * D * R)}
    out["leaf_tile"] = leaf_tile
    print(f"[scheduler tas host] the device fill costs "
          f"{out['fill_over_rollup_ms']:.4f} ms a fill over the host "
          f"roll-up, timed fill by fill ({c['fill_ms']:.4f} against "
          f"{c['host_rollup_ms']:.4f}); "
          f"fill_counts at the fill's {tree.n_domains}-domain tree: "
          + json.dumps(tile) + f"; leaf_states at its {D}x{R} tile: "
          + json.dumps(leaf_tile))
    return out, fill_total, leaf_total, place_total


def timed_store_digest(store) -> str:
    """``committed_store_digest`` plus each workload's QuotaReserved
    transition time (the copy of tests/torch_streaming_pins.py's, held
    to it by the tests)."""
    import hashlib

    times = []
    for key in sorted(store.workloads):
        c = store.workloads[key].status.conditions.get("QuotaReserved")
        times.append(None if c is None else [c.status,
                                             c.last_transition_time])
    return hashlib.sha256(json.dumps(
        [committed_store_digest(store), times],
        separators=(",", ":")).encode()).hexdigest()


def _queue_state(queues) -> dict:
    """Each ClusterQueue's heap and parked keys."""
    return {name: (sorted(q._in_heap), sorted(q.inadmissible))
            for name, q in sorted(queues.queues.items())}


def _admission_rows(store, keys) -> list:
    """The committed admission of each key: ClusterQueue, per podset
    the flavors, count and usage, and the QuotaReserved and Admitted
    conditions with their times."""
    rows = []
    for key in keys:
        wl = store.workloads[key]
        adm = wl.status.admission
        rows.append([key, adm.cluster_queue,
                     [[sorted(p.flavors.items()), p.count,
                       sorted(p.resource_usage.items())]
                      for p in adm.podset_assignments],
                     [(c.status, c.last_transition_time) for t, c in
                      sorted(wl.status.conditions.items())]])
    return rows


class _StreamTwin:
    """One twin of bench.py's streaming arm on the port: a fresh fleet,
    ``Scheduler(solver="auto", solver_min_backlog=0, streaming=...)`` on
    ``device`` and the tick driver, stepped one event at a time with its
    wall, its micro-solve entries and seconds, and its boundary digests,
    frames and export modes."""

    def __init__(self, profile, twin, device, per_tick, ticks,
                 solve_every) -> None:
        from kueue_oss_tpu_torch.api import types
        from kueue_oss_tpu_torch.core.queue_manager import QueueManager
        from kueue_oss_tpu_torch.core.store import Store
        from kueue_oss_tpu_torch.scenarios import (
            streaming_store,
            streaming_ticks,
        )
        from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler

        self.twin = twin
        self.device = device
        self.store = streaming_store(types, Store, profile=profile)
        self.queues = QueueManager(self.store)
        self.sched = Scheduler(self.store, self.queues, solver="auto",
                               solver_min_backlog=0,
                               streaming=twin != "batch", device=device)
        relax_off(self.sched._solver_engine())
        if twin == "host":
            self.sched._streaming_admitter().micro_solve = False
        self.events = streaming_ticks(
            types, self.store, self.sched, ticks=ticks,
            per_tick=per_tick, stream=twin != "batch",
            solve_every=solve_every)
        self.wall = self.export_s = self.solve_s = 0.0
        self.micro_entries = self.micro_solves = 0
        self.boundaries, self.committed, self.frames = [], [], []

    def step(self):
        """The next event of the tick driver, timed; None at the end."""
        import torch

        t0 = time.monotonic()
        ev = next(self.events, None)
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.wall += time.monotonic() - t0
        if ev is None:
            return None
        kind, tick, res = ev
        if kind == "micro":
            self.micro_entries += res.micro_batch
            self.micro_solves += res.micro_batch > 0
            self.export_s += res.micro_export_s
            self.solve_s += res.micro_solve_s
        else:
            self.boundaries.append(timed_store_digest(self.store))
            self.committed.append(committed_store_digest(self.store))
            self.frames.append({
                "tick": tick, "admitted": res.admitted,
                "rounds": res.rounds, **res.export_stats,
                **_frame_summary(res),
                "device_put_bytes": res.device.get(
                    "donated_update_bytes", 0) + res.device.get(
                    "full_upload_bytes", 0),
                **{f"{k}_s": v for k, v in res.phases.items()}})
        return ev

    def run(self) -> None:
        while self.step() is not None:
            pass

    def record(self) -> dict:
        """The twin's record in the form STREAMING_REFERENCE pins it."""
        from kueue_oss_tpu_torch.scenarios import time_to_admit_ms

        sa = self.sched._streaming_instance
        return {"workloads": len(self.store.workloads),
                **time_to_admit_ms(self.store),
                "stream_admitted": (sa.counts["stream_admitted_total"]
                                    if sa is not None else 0),
                "micro_entries": self.micro_entries,
                "micro_solves": self.micro_solves,
                "boundaries": self.boundaries,
                "committed": self.committed}

    def report(self) -> dict:
        rec = self.record()
        out = {"wall_s": self.wall, "tta_ms_p50": rec["tta_ms_p50"],
               "tta_ms_p95": rec["tta_ms_p95"],
               "stream_admitted": rec["stream_admitted"],
               "boundary_drains": self.frames}
        if self.micro_solves:
            out.update(micro_solves=self.micro_solves,
                       micro_entries=self.micro_entries,
                       export_s_per_micro_solve=(self.export_s
                                                 / self.micro_solves),
                       solve_s_per_micro_solve=(self.solve_s
                                                / self.micro_solves))
        return out


def _lockstep(a: _StreamTwin, b: _StreamTwin) -> int:
    """Step two streaming twins together; after every micro-drain their
    outcomes, the committed admissions of the keys admitted (as a set:
    the commit order may differ) and every
    queue's heap and parked sets must be equal (a micro-drain changes
    nothing else in the store), and at every boundary their timestamped
    digests. Returns the micro-drains compared."""
    compared = 0
    while True:
        ea, eb = a.step(), b.step()
        if ea is None or eb is None:
            if ea is not eb:
                raise AssertionError("streaming twins ended apart")
            return compared
        if ea[:2] != eb[:2]:
            raise AssertionError(f"streaming twins out of step: {ea[:2]} "
                                 f"!= {eb[:2]}")
        kind, tick, ra = ea
        rb = eb[2]
        if kind == "micro":
            # the micro-solve commits in (round, entry) order, the host
            # walk ClusterQueue by ClusterQueue: the same set
            keys = sorted(ra.admitted_keys)
            if ((ra.admitted, ra.parked, ra.deferred_cqs, keys)
                    != (rb.admitted, rb.parked, rb.deferred_cqs,
                        sorted(rb.admitted_keys))
                    or _admission_rows(a.store, keys)
                    != _admission_rows(b.store, keys)
                    or _queue_state(a.queues) != _queue_state(b.queues)):
                raise AssertionError(
                    f"{a.twin} and {b.twin} twins differ after the "
                    f"micro-drain of tick {tick}")
            compared += 1
        elif a.boundaries[-1] != b.boundaries[-1]:
            raise AssertionError(f"{a.twin} and {b.twin} twins differ at "
                                 f"the boundary of tick {tick}")


def _counted_micro_solves(log: list):
    """Wrap the admitter's lean-drain entry to log (thread, device,
    padded workloads) per micro-solve; returns the restore call."""
    import threading

    from kueue_oss_tpu_torch.scheduler import streaming

    inner = streaming.solve_backlog

    def counted(t):
        log.append((threading.current_thread().name,
                    t.wl_rank.device.type, int(t.wl_rank.shape[0])))
        return inner(t)

    streaming.solve_backlog = counted

    def restore():
        streaming.solve_backlog = inner

    return restore


def streaming_fleets(device="cuda", runs=None, reference=None,
                     solve_every: int = 100) -> tuple:
    """Phase 15 (a) and (b): bench.py's streaming arm through the
    port's scheduler, every twin against its JAX pin. Returns (report,
    TAS kernel launches)."""
    runs = runs or STREAMING_RUNS
    reference = reference or STREAMING_REFERENCE
    out, launches = {}, 0
    log: list = []
    restore = _counted_micro_solves(log)
    try:
        for profile, (per_tick, ticks, twins) in runs.items():
            made = {t: _StreamTwin(profile, t, device, per_tick, ticks,
                                   solve_every) for t in twins}
            _reset_launches()
            _settle()
            compared = 0
            if "micro" in made:
                # the device micro-solve against the host walk
                compared = _lockstep(made["micro"], made["host"])
            for tw in made.values():
                tw.run()
            launches += _launches()
            stream = made.get("micro") or made["stream"]
            for name, tw in made.items():
                rec = tw.record()
                want = reference[profile][name]
                if rec != want:
                    raise AssertionError(
                        f"streaming {profile} {name}: {rec} != reference "
                        f"{want}")
            if stream.committed != made["batch"].committed:
                raise AssertionError(f"streaming {profile}: the stream "
                                     f"and batch twins differ at a "
                                     f"boundary")
            if _launches():
                raise AssertionError(f"streaming {profile}: "
                                     f"{_launches()} TAS kernel launches")
            solves = [e for e in log if e[0] != "stream-watch-drain"]
            if "micro" in made and (
                    len(solves) != stream.micro_solves
                    or any(dev != device for _, dev, _ in solves)):
                raise AssertionError(
                    f"streaming {profile}: {len(solves)} micro-solves "
                    f"logged on {sorted({d for _, d, _ in solves})} for "
                    f"{stream.micro_solves} micro-drains")
            log.clear()
            out[profile] = {name: tw.report() for name, tw in made.items()}
            out[profile]["micro_drains_compared"] = compared
            print(f"[streaming {profile}] every twin matches its JAX pin "
                  f"({per_tick} arrivals a tick, {ticks} ticks); stream = "
                  f"batch at {len(stream.committed)} boundaries"
                  + (f"; micro-solve = host walk after {compared} "
                     f"micro-drains" if compared else "")
                  + "; " + json.dumps(out[profile]))
    finally:
        restore()
    return out, launches


def streaming_serve(device="cuda", bursts: int = 8,
                    per_burst: int = 128, singles: int = 8) -> dict:
    """Phase 15 (c): ``serve(stop)`` in a thread over a fresh ``single``
    fleet with the watch-driven worker; ``bursts`` bursts of
    ``per_burst`` injected from this thread. Each burst is added while
    this thread holds the cycle lock and the queue lock, and the cycle
    lock is handed over first, so the worker (woken by the arrivals)
    takes it before the serve loop can: the burst then coalesces into
    one micro-drain on the worker thread. Each burst's wall from
    injection to the last admission (``burst_handover_s``) holds that
    0.1 s hand-over and is no serve latency. Then ``singles`` arrivals
    are added one at a time with no lock held, each waited on until it
    holds quota: ``single_admit_s`` is one arrival's wall from
    ``add_workload`` to its admission by whichever thread takes it. A
    thread that dies fails the phase."""
    import threading

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.config import StreamingConfig
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import streaming_store
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler

    store = streaming_store(types, Store, profile="single")
    queues = QueueManager(store)
    sched = Scheduler(store, queues, solver="auto", device=device,
                      streaming=StreamingConfig(enabled=True,
                                                watch_driven=True))
    relax_off(sched._solver_engine()).drain(now=time.monotonic(),
                                            verify=True)
    sa = sched._streaming_admitter()
    drains: list = []
    inner_drain = sa.drain

    def logged_drain(now=0.0):
        res = inner_drain(now)
        drains.append((threading.current_thread().name, res.micro_batch,
                       res.admitted))
        return res

    sa.drain = logged_drain
    errors: list = []
    hook = threading.excepthook

    def excepthook(args):
        errors.append(f"{args.thread.name if args.thread else '?'}: "
                      f"{args.exc_type.__name__}: {args.exc_value}")
        hook(args)

    log: list = []
    restore = _counted_micro_solves(log)
    threading.excepthook = excepthook
    stop = threading.Event()
    server = threading.Thread(target=sched.serve, args=(stop,),
                              kwargs={"poll": 0.01}, name="serve")
    n_cqs = len(store.cluster_queues)
    latencies, single_latencies = [], []
    try:
        server.start()
        deadline = time.monotonic() + 30.0
        while sa._notify is None and time.monotonic() < deadline:
            time.sleep(0.005)
        workers = [t for t in threading.enumerate()
                   if t.name == "stream-watch-drain"]
        if sa._notify is None or len(workers) != 1:
            raise AssertionError(f"serve did not start its worker "
                                 f"({len(workers)} found)")
        uid = 1
        for _ in range(bursts):
            keys = []
            sched._cycle_mu.acquire()
            queues._mu.acquire()
            try:
                t_inj = time.monotonic()
                for _ in range(per_burst):
                    wl = types.Workload(
                        name=f"s{uid}", queue_name=f"lq{uid % n_cqs}",
                        uid=uid, creation_time=t_inj,
                        podsets=[types.PodSet(count=1,
                                              requests={"cpu": 100})])
                    store.add_workload(wl)
                    keys.append(wl.key)
                    uid += 1
            finally:
                sched._cycle_mu.release()
                # the woken worker takes the cycle lock while the serve
                # loop still waits for the queue lock
                time.sleep(0.1)
                queues._mu.release()
            deadline = time.monotonic() + 60.0
            while (not all(store.workloads[k].is_quota_reserved
                           for k in keys)
                   and time.monotonic() < deadline and not errors):
                time.sleep(0.002)
            latencies.append(time.monotonic() - t_inj)
            if not all(store.workloads[k].is_quota_reserved for k in keys):
                raise AssertionError(f"serve: a burst was not admitted "
                                     f"within 60 s ({errors})")
        for _ in range(singles):
            t_inj = time.monotonic()
            wl = types.Workload(
                name=f"s{uid}", queue_name=f"lq{uid % n_cqs}", uid=uid,
                creation_time=t_inj,
                podsets=[types.PodSet(count=1, requests={"cpu": 100})])
            store.add_workload(wl)
            uid += 1
            deadline = t_inj + 60.0
            while (not store.workloads[wl.key].is_quota_reserved
                   and time.monotonic() < deadline and not errors):
                time.sleep(0.0005)
            single_latencies.append(time.monotonic() - t_inj)
            if not store.workloads[wl.key].is_quota_reserved:
                raise AssertionError(f"serve: a single arrival was not "
                                     f"admitted within 60 s ({errors})")
        alive = server.is_alive() and workers[0].is_alive()
    finally:
        stop.set()
        server.join(timeout=30.0)
        workers_left = [t for t in threading.enumerate()
                        if t.name == "stream-watch-drain"]
        for t in workers_left:
            t.join(timeout=30.0)
        threading.excepthook = hook
        restore()
        sa.drain = inner_drain
    if errors:
        raise AssertionError(f"serve: a thread died: {errors}")
    if not alive:
        raise AssertionError("serve: the serve or worker thread ended "
                             "before stop")
    if server.is_alive() or any(t.is_alive() for t in workers_left):
        raise AssertionError("serve: a thread outlived stop")
    worker_micro = sum(m for name, m, _ in drains
                       if name == "stream-watch-drain")
    worker_solves = [e for e in log if e[0] == "stream-watch-drain"]
    if not worker_micro or any(dev != device for _, dev, _ in worker_solves):
        raise AssertionError(f"serve: the worker's micro-solves "
                             f"{worker_solves} (entries {worker_micro})")
    held = sum(1 for w in store.workloads.values() if w.is_quota_reserved)
    if held != bursts * per_burst + singles:
        raise AssertionError(f"serve: {held} of "
                             f"{bursts * per_burst + singles} admitted")
    counts = sa.counts
    out = {"admitted": held,
           "stream_admitted": counts["stream_admitted_total"],
           "worker_drains": sum(1 for d in drains
                                if d[0] == "stream-watch-drain"),
           "worker_micro_entries": worker_micro,
           "worker_micro_solves": len(worker_solves),
           "serve_micro_entries": sum(m for name, m, _ in drains
                                      if name == "serve"),
           "watch_coalesced": counts["stream_demotions_total"][
               "watch_coalesced"],
           "burst_handover_s": latencies,
           "single_admit_s": single_latencies}
    print("[streaming serve] all admitted; the worker ran micro-solves on "
          f"{device}; threads joined; " + json.dumps(out))
    return out


def relax_off(engine):
    """Pin the engine's relaxed arm off (returns the engine): its router
    decides by wall clock, and the JAX pins of phases 5 and 10-16 were
    computed with the arm off on both sides (tests/torch_*_pins.py)."""
    engine.relax_enabled = False
    return engine


def pin_cost_gates(sched) -> None:
    """Reset the scheduler's two routing cost EMAs before every routing
    decision (a wrapper on the instance), so the count-based gate routes
    as it did for the JAX pins (the copy of tests/torch_sim_pins.py's,
    held to it by the tests)."""
    inner = sched._solver_drain

    def solver_drain(now):
        sched._drain_cost_ema = None
        sched._host_s_per_adm = None
        return inner(now)

    sched._solver_drain = solver_drain


def plan_digest(arrays) -> str:
    """sha256 over each array's dtype, shape and bytes (the copy of
    tests/torch_sim_pins.py's, held to it by the tests)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        a = a.cpu().numpy() if hasattr(a, "cpu") else a
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _sim_record(stats, store) -> dict:
    return {"admitted": stats.admitted, "finished": stats.finished,
            "preemptions": stats.preemptions, "cycles": stats.cycles,
            "sim_wall_ms": stats.sim_wall_ms,
            "tta_ms_by_class": dict(sorted(stats.tta_ms_by_class.items())),
            "digest": timed_store_digest(store)}


def _large_scale(gen, per_cq=(35, 11, 4), n_cohorts=10,
                 cqs_per_cohort=100):
    """Kueue's large-scale config without preemption."""
    cfg = gen.GeneratorConfig.large_scale(preemption=False)
    cfg.n_cohorts, cfg.cqs_per_cohort = n_cohorts, cqs_per_cohort
    for wc, n in zip(cfg.classes, per_cq):
        wc.count = n
    return cfg


def perf_runner(smi: str) -> tuple:
    """Phase 16: the perf runner, host only (a) and auto (b) on the
    baseline config, and drain_benchmark on the large-scale config (c).
    Returns (report, TAS kernel launches, (c)'s store and exact plan,
    which phase 18 (b) reuses)."""
    import torch

    from kueue_oss_tpu_torch import native
    from kueue_oss_tpu_torch.perf import (
        BASELINE_SPEC,
        GeneratorConfig,
        Simulator,
        check,
        drain_benchmark,
        generate,
    )
    from kueue_oss_tpu_torch.perf import generator
    from kueue_oss_tpu_torch.solver import kernels
    from kueue_oss_tpu_torch.solver.tensors import UnsupportedProblem

    out = {}
    launches = 0
    # (a) host cycles only
    store, schedule = generate(GeneratorConfig.baseline())
    sim = Simulator(store, schedule)
    _reset_launches()
    _settle()
    stats = sim.run()
    launches += _launches()
    rec = _sim_record(stats, store)
    if rec != SIM_REFERENCE["host"]:
        raise AssertionError(f"perf runner host-only: {rec}; expected "
                             f"{SIM_REFERENCE['host']}")
    violations = check(stats, BASELINE_SPEC)
    if violations:
        raise AssertionError(f"perf runner host-only: BASELINE_SPEC "
                             f"violations {violations}")
    out["host"] = {"wall_s": stats.real_seconds,
                   "admissions_per_real_second":
                       stats.admissions_per_real_second}
    print(f"[perf runner] (a) host only: the JAX record ({stats.summary()}"
          f"); BASELINE_SPEC holds; wall {stats.real_seconds:.3f} s "
          f"({smi})")

    # (b) solver="auto" on the card, the cost gates pinned, at
    # PERF_AUTO_SCALE of the baseline's depth (cut for the script's time)
    cfg = GeneratorConfig.baseline()
    for wc in cfg.classes:
        wc.count = max(1, round(wc.count * PERF_AUTO_SCALE))
    store, schedule = generate(cfg)
    sim = Simulator(store, schedule, solver="auto")
    sched = sim.scheduler
    pin_cost_gates(sched)
    engine = relax_off(sched._solver_engine())
    inner = engine.drain
    results, unsupported = [], [0]

    def drain(*args, **kwargs):
        try:
            result = inner(*args, **kwargs)
        except UnsupportedProblem:
            unsupported[0] += 1
            raise
        results.append(result)
        return result

    engine.drain = drain
    native.reset_counters()
    _reset_launches()
    _settle()
    t0 = time.monotonic()
    stats = sim.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches += _launches()
    rec = _sim_record(stats, store)
    rec.update(drains=len(results), unsupported=unsupported[0],
               drain_admitted=sum(r.admitted for r in results))
    counts = sched.solver_counts
    oracle = dict(native.counters)
    if rec != SIM_REFERENCE["auto"]:
        raise AssertionError(f"perf runner auto: {rec}; expected "
                             f"{SIM_REFERENCE['auto']}")
    if (counts["drains"] != len(results) or counts["plan_fallbacks"]
            or counts["unsupported"] or counts["unavailable"]
            or any(r.plan_fallbacks for r in results)
            or any(r.admitted and not r.verified for r in results)
            or oracle["python_calls"] or not oracle["native_calls"]):
        raise AssertionError(f"perf runner auto: solver counts {counts}, "
                             f"oracle {oracle}")
    phases = collections.Counter()
    for r in results:
        phases.update(r.phases)
    rounds = sum(r.rounds for r in results)
    out["auto"] = {"wall_s": wall, "drains": len(results),
                   "rounds": rounds, "verified": sum(r.verified
                                                     for r in results),
                   "phases_s": dict(phases)}
    print(f"[perf runner] (b) auto: the JAX record ({stats.summary()}); "
          f"{len(results)} drains, {rounds} rounds, every one re-checked "
          f"by the native oracle ({int(oracle['native_calls'])} calls), 0 "
          f"fallbacks; wall {wall:.3f} s, drains' phases "
          f"{json.dumps({k: round(v, 3) for k, v in phases.items()})} "
          f"({smi})")

    # (c) drain_benchmark at Kueue's large-scale size, after an untimed
    # warm-up run on a small store (the first launches of the process)
    drain_benchmark(*generate(_large_scale(generator, n_cohorts=2,
                                           cqs_per_cohort=5)))
    plans = []
    solve = kernels.solve_backlog

    def recorded(t):
        plans.append(solve(t))
        return plans[-1]

    store, schedule = generate(_large_scale(generator))
    _reset_launches()
    _settle()
    kernels.solve_backlog = recorded
    try:
        bench = drain_benchmark(store, schedule)
    finally:
        kernels.solve_backlog = solve
    launches += _launches()
    rec = {k: bench[k] for k in ("workloads", "cluster_queues",
                                 "admitted", "rounds")}
    rec["plan_digest"] = plan_digest(plans[0])
    if len(plans) != 1 or rec != DRAIN_LARGE_REFERENCE:
        raise AssertionError(f"drain_benchmark: {rec} over {len(plans)} "
                             f"solves; expected {DRAIN_LARGE_REFERENCE}")
    out["drain_large"] = {k: bench[k] for k in (
        "solve_seconds", "cycle_ms", "admissions_per_second")}
    print(f"[perf runner] (c) drain_benchmark: the JAX plan "
          f"({bench['admitted']} of {bench['workloads']} admitted over "
          f"{bench['cluster_queues']} ClusterQueues in {bench['rounds']} "
          f"rounds); solve_seconds {bench['solve_seconds']:.3f}, cycle_ms "
          f"{bench['cycle_ms']:.3f} (after a warm-up run) ({smi})")
    if launches:
        raise AssertionError(f"perf runner: {launches} TAS kernel "
                             f"launches; expected 0")
    return out, launches, (store, plans[0])


def bench_whatif_problem():
    """bench.py's whatif shape on the port (the copy of
    tests/torch_sim_pins.py's ``bench_whatif_problem``): 2 x 4
    ClusterQueues with 14 / 4 / 2 workloads each (W = 160, padded to
    256), 128 scenarios of the quota x arrival grid, tiled."""
    from kueue_oss_tpu_torch import sim
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.perf import generator
    from kueue_oss_tpu_torch.solver import tensors

    store, schedule = generator.generate(_large_scale(
        generator, (14, 4, 2), n_cohorts=2, cqs_per_cohort=4))
    for g in schedule:
        store.add_workload(g.workload)
    pending = sim.pending_backlog(store, QueueManager(store))
    problem = tensors.export_problem(
        store, pending, cache=tensors.ExportCache(store, subscribe=False))
    problem = tensors.pad_workloads(problem,
                                    tensors.pow2(problem.n_workloads))
    specs = sim.cross(sim.quota_sweep(BENCH_QUOTA),
                      sim.arrival_sweep(BENCH_ARRIVAL))
    specs = (specs * (128 // len(specs) + 1))[:128]
    return problem, [s.overlay(problem, replicas=1) for s in specs]


def whatif_sweeps(smi: str) -> tuple:
    """Phase 17: bench.py's whatif shape batched against the sequential
    oracle (a), and WhatIfEngine on the baseline backlog (b). Returns
    (report, TAS kernel launches)."""
    import hashlib

    from kueue_oss_tpu_torch import sim
    from kueue_oss_tpu_torch.perf import GeneratorConfig, generate
    from kueue_oss_tpu_torch.sim import batch as sim_batch

    out = {}
    launches = 0
    # (a) 128 scenarios over W = 160, C = 8
    problem, overlays = bench_whatif_problem()
    _reset_launches()
    _settle()
    batch = sim.solve_scenarios(problem, overlays)
    again = sim.solve_scenarios(problem, overlays)
    seq = sim.solve_scenarios_sequential(problem, overlays)
    launches += _launches()
    parity = sim.check_parity(batch, seq, range(len(overlays)))
    rec = {"scenarios": len(overlays),
           "max_rounds": int(batch.rounds.max()),
           "rounds_sum": int(batch.rounds.sum()),
           "admitted_sum": int(batch.admitted.sum()),
           "plan_digest": plan_digest((
               batch.admitted, batch.opt, batch.admit_round, batch.parked,
               batch.rounds, batch.usage))}
    if rec != WHATIF_BENCH_REFERENCE or not parity.identical:
        raise AssertionError(f"whatif bench: {rec}, parity "
                             f"{parity.mismatches[:4]}; expected "
                             f"{WHATIF_BENCH_REFERENCE}")
    if plan_digest((again.admitted, again.opt, again.admit_round,
                    again.parked, again.rounds, again.usage)) != (
            rec["plan_digest"]):
        raise AssertionError("whatif bench: a second batch differs")
    ratio = seq.solve_seconds / again.solve_seconds
    out["bench"] = {"batched_s": [batch.solve_seconds, again.solve_seconds],
                    "sequential_s": seq.solve_seconds,
                    "scenarios_per_s": len(overlays) / again.solve_seconds,
                    "sequential_over_batched": ratio,
                    "batch_width": batch.batch_width,
                    "host_reads": batch.host_reads,
                    "sequential_host_reads": seq.host_reads}
    print(f"[whatif] (a) bench shape: the JAX plans of 128 scenarios "
          f"(max {rec['max_rounds']} rounds), batched == sequential on "
          f"all 128; batched {batch.solve_seconds:.3f} s / "
          f"{again.solve_seconds:.3f} s ({batch.host_reads} host reads), "
          f"{len(overlays) / again.solve_seconds:.1f} scenarios/s; "
          f"sequential {seq.solve_seconds:.3f} s ({seq.host_reads} host "
          f"reads), {ratio:.1f}x the batch ({smi})")

    # (b) WhatIfEngine on the baseline backlog, 15,000 pending at t0
    store, schedule = generate(GeneratorConfig.baseline())
    for g in schedule:
        store.add_workload(g.workload)
    specs = sim.cross(sim.quota_sweep(WHATIF_QUOTA),
                      sim.arrival_sweep(WHATIF_ARRIVAL))
    dispatches = []
    solve = sim_batch.solve_scenarios

    def logged(*args, **kwargs):
        r = solve(*args, **kwargs)
        dispatches.append({"width": r.batch_width,
                           "max_rounds": int(r.rounds.max()),
                           "wall_s": r.solve_seconds,
                           "host_reads": r.host_reads})
        return r

    _reset_launches()
    _settle()
    sim_batch.solve_scenarios = logged
    try:
        t0 = time.monotonic()
        report = sim.WhatIfEngine(store).run(specs)
        wall = time.monotonic() - t0
    finally:
        sim_batch.solve_scenarios = solve
    launches += _launches()
    rows = report.scenarios
    rec = {"canonical_sha256": hashlib.sha256(
               report.canonical_json().encode()).hexdigest(),
           "max_rounds": max(r["rounds"] for r in rows),
           "rounds_sum": sum(r["rounds"] for r in rows),
           "admitted_sum": sum(r["admitted"] for r in rows),
           "parity": report.parity,
           "batch_dispatches": report.timing["batch_dispatches"],
           "round_buckets": report.timing["round_buckets"]}
    if (rec != WHATIF_BASELINE_REFERENCE
            or len(dispatches) != rec["batch_dispatches"]):
        raise AssertionError(f"whatif baseline: {rec}, dispatches "
                             f"{dispatches}; expected "
                             f"{WHATIF_BASELINE_REFERENCE}")
    timing = report.timing
    out["baseline"] = {"wall_s": wall, "dispatches": dispatches,
                       **{k: timing[k] for k in (
                           "build_seconds", "solve_seconds",
                           "parity_seconds", "report_seconds",
                           "scenarios_per_sec")}}
    print(f"[whatif] (b) baseline backlog: canonical_json equals the JAX "
          f"report (sha256 {rec['canonical_sha256'][:16]}), {len(specs)} "
          f"scenarios in {len(dispatches)} dispatches "
          f"{json.dumps(dispatches)}, parity identical on 2 "
          f"({timing['parity_seconds']:.3f} s); wall {wall:.3f} s, solve "
          f"{timing['solve_seconds']:.3f} s ({smi})")
    if launches:
        raise AssertionError(f"whatif: {launches} TAS kernel launches; "
                             f"expected 0")
    return out, launches


def _relax_index_on(lp, device, cluster=None):
    """The kernel's lists and cluster cut of a numpy RelaxLP, on the card
    (made once, outside the timed launches)."""
    from kueue_oss_tpu_torch.solver import cuda_relax

    return cuda_relax.index_on(cuda_relax.lp_index(
        lp.wl_cqid, lp.parent, lp.cq_node, lp.cq_node.shape[-1],
        live=lp.live, cluster=cluster), device)


def _relax_work(lp, iters: int) -> tuple[int, int]:
    """Bytes and float32 operations of relax_lp on a numpy RelaxLP: each
    LP field read once and x written once; per iteration and scenario,
    the multiply-add of every listed row into its CQ's load, the level
    adds of the tree, the relative overflow of every node, the path sums
    and, for every live row, its price pull and update."""
    import numpy as np

    f = lp.r.shape[-1]
    nbytes = sum(int(np.asarray(a).nbytes) for a in lp) + 4 * lp.s.size
    cqid = np.atleast_2d(lp.wl_cqid)
    n_cqs = lp.cq_node.shape[-1]
    listed = int((cqid < n_cqs).sum())
    live = int(np.asarray(lp.live).sum())
    depth = np.atleast_2d(lp.depth)
    levels = lp.path_cq.shape[-1]
    n1 = depth.shape[-1]
    s = depth.shape[0]
    per_iter = (2 * listed * f + s * (levels - 1) * n1 * f
                + 4 * s * n1 * f + s * n_cqs * f * levels
                + live * (4 * f + 7))
    return nbytes, iters * per_iter


def _repeated_lp(lp, times: int):
    """A numpy RelaxLP whose rows (all but the padding row) repeat
    ``times`` times over the same ClusterQueues and tree: a backlog
    ``times`` as deep."""
    import numpy as np

    rows = {f: np.concatenate([getattr(lp, f)[:-1]] * times
                              + [getattr(lp, f)[-1:]])
            for f in ("r", "s", "live", "wl_cqid")}
    return lp._replace(**rows)


def check_relax_lp(device, cases) -> dict:
    """Phase 18 (a): ``relax_lp`` against the plain ``relax.lp_loop`` run
    on the CPU (float ``index_add_`` on the card adds in any order), x
    bit for bit, on each case (name, numpy RelaxLP, iterations, whether
    to time the plain loop, other cluster sizes to check and time); CUDA
    event times of the kernel and of the plain loop on the card. Returns
    the report of the first case (the main path's shape) with every
    case's time, cluster size and layout."""
    import numpy as np

    from kueue_oss_tpu_torch.solver import cuda_relax, relax

    report = None
    for name, lp, iters, time_plain, sweep in cases:
        dl = relax.lp_to_device(lp, device)
        want = relax.lp_loop(relax.lp_to_device(lp, "cpu"), iters).numpy()
        F, N1 = lp.r.shape[-1], lp.parent.shape[-1]
        runs = {}
        for cluster in (None, *sweep):
            index = _relax_index_on(lp, device, cluster)
            where = cuda_relax.LAYOUTS[cuda_relax.layout(index, F, N1)]
            got = cuda_relax.relax_lp(dl, iters, index).cpu().numpy()
            err = float(np.abs(got - want).max())
            if got.shape != want.shape or not np.array_equal(
                    got.view(np.int32), want.view(np.int32)):
                raise AssertionError(
                    f"relax_lp differs from the plain loop on {name!r} "
                    f"(cluster {index.cluster}, layout {where}, max abs "
                    f"err {err})")
            runs[cluster] = (index, where, err, _time_ms(
                lambda: cuda_relax.relax_lp(dl, iters, index), iters=20,
                warmup=3))
        index, where, err, ms = runs[None]
        plain_ms = (_time_ms(lambda: relax.lp_loop(dl, iters), iters=3,
                             warmup=1) if time_plain else None)
        nbytes, nops = _relax_work(lp, iters)
        inside = float(((want > 0) & (want < 1)).mean())
        sizes = {str(r[0].cluster): r[3] for r in runs.values()}
        print(f"[kernel] relax_lp == lp_loop (CPU) bit for bit on {name} "
              f"{list(lp.r.shape)} C={lp.cq_node.shape[-1]} "
              f"iters={iters}, a cluster of {index.cluster} "
              f"({index.max_rows} rows a block at most), rows in {where}: "
              f"{ms:.4f} ms (ms by cluster size {json.dumps(sizes)}), "
              f"plain on the card {plain_ms} ms, bound "
              f"{_bound(nbytes, nops)['bound_ms']:.2e} ms; "
              f"{inside:.3f} of x strictly inside (0, 1)")
        case = {"case": name, "shape": list(lp.r.shape),
                "cluster": index.cluster, "layout": where,
                "threads": cuda_relax.block_threads(index, F, N1),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **_bound(nbytes, nops)}
        if sweep:
            case["ms_by_cluster"] = sizes
        if report is None:
            report = {**case, "name": "relax_lp", "route": "cuda",
                      "source": "kueue_oss_tpu_torch/csrc/relax_lp.cu",
                      "replaces": "kueue_oss_tpu/solver/relax.py:144",
                      "replaces_kind": "lp_loop, an XLA program (no "
                                       "Pallas kernel)",
                      "exact": err == 0.0, "iters": iters,
                      "library_ms": None, "cases": []}
        report["cases"].append(case)
    return report


def _relax_churn(audit_every: int) -> tuple:
    """Phase 18 (c): bench.py's relax churn (bench.py:2053-2090) on its
    small shape (2 x 10 ClusterQueues) through the router: ``relax_force``,
    ``relax_audit_every``, a host ``Scheduler`` attached,
    ``drain(verify=True)``, then 4 cycles of 32 finishes and 32 arrivals,
    each drained; held to the JAX record. Returns (record, the drains'
    results, wall seconds, relax_lp launches)."""
    import torch

    from kueue_oss_tpu_torch import native
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.perf import generate, generator
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_oss_tpu_torch.solver import cuda_relax
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    cfg = _large_scale(generator, n_cohorts=2, cqs_per_cohort=10)
    store, schedule = generate(cfg)
    for g in schedule:
        store.add_workload(g.workload)
    queues = QueueManager(store)
    engine = SolverEngine(store, queues)
    sched = Scheduler(store, queues)
    engine.scheduler = sched
    engine.relax_force = True
    engine.relax_audit_every = audit_every
    engine.pad_to = len(schedule) + 512
    native.reset_counters()
    cuda_relax.relax_lp.launches = 0
    _reset_launches()
    _settle()
    t0 = time.monotonic()
    results = [engine.drain(now=0.0, verify=True)]
    lqs = sorted({w.queue_name for w in store.workloads.values()})
    uid = max(w.uid for w in store.workloads.values()) + 1
    for c in range(1, 5):
        admitted = [k for k, w in store.workloads.items()
                    if w.is_quota_reserved and not w.is_finished]
        for k in admitted[:32]:
            sched.finish_workload(k, now=float(c))
        for j in range(32):
            i = uid + c * 32 + j
            store.add_workload(types.Workload(
                name=f"churn-{c}-{j}", queue_name=lqs[i % len(lqs)], uid=i,
                creation_time=1e6 + c * 32 + j,
                podsets=[types.PodSet(name="main", count=1,
                                      requests={"cpu": 1})]))
        results.append(engine.drain(now=float(c), verify=True))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n = cuda_relax.relax_lp.launches
    counts = engine.relax_counts["solver_relax_drains_total"]
    rec = {"drains": len(results),
           "admitted": [r.admitted for r in results],
           "audit_match": counts["audit_match"],
           "audit_diverged": counts["audit_diverged"],
           "served": counts["served"], "error": counts["error"],
           "oracle_rejections": sum(r.plan_fallbacks for r in results),
           "digest": committed_store_digest(store)}
    want = RELAX_REFERENCE["churn" if audit_every == 1 else "churn_served"]
    oracle = dict(native.counters)
    if (rec != want or n != len(results) or oracle["python_calls"]
            or not oracle["native_calls"]):
        raise AssertionError(f"relax churn (audit every {audit_every}): "
                             f"{rec}, {n} relax_lp launches, oracle "
                             f"{oracle}; expected {want}")
    return rec, results, wall, n


def relax_phase(smi: str, large_store, large_exact) -> tuple:
    """Phase 18: the relaxed arm. (a) the kernel against its plain
    version at the main path's LPs; (b) ``solve_relaxed`` over the
    large-scale backlog of phase 16 (c), against its exact plan; (c)
    bench.py's relax churn through the router on bench's small shape;
    (d) the relax tier over 32 whatif scenarios. Returns (report,
    relax_lp kernel report, TAS kernel launches)."""
    import hashlib

    import numpy as np
    import torch

    from kueue_oss_tpu_torch import scenarios, sim
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.perf import GeneratorConfig, generate
    from kueue_oss_tpu_torch.sim import batch as sim_batch
    from kueue_oss_tpu_torch.solver import cuda_relax, relax, tensors
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    device = torch.device("cuda")
    out = {}
    # the main path's problems: the large-scale backlog (b), the
    # baseline backlog of the what-if engine (W+1 = 16,385, C = 30),
    # and the 32 whatif worlds of (d)
    problem, _ = SolverEngine(large_store,
                              QueueManager(large_store)).export()
    padded = tensors.pad_workloads(problem,
                                   tensors.pow2(problem.n_workloads))
    store, schedule = generate(GeneratorConfig.baseline())
    for g in schedule:
        store.add_workload(g.workload)
    base = tensors.export_problem(
        store, sim.pending_backlog(store, QueueManager(store)),
        cache=tensors.ExportCache(store, subscribe=False))
    base = tensors.pad_workloads(base, tensors.pow2(base.n_workloads))
    bench, overlays = bench_whatif_problem()
    overlays = overlays[:32]
    _, _, stacked = sim_batch.stack_relax_lps(bench, overlays)

    # (a) the kernel against its plain version: the main path's LPs (the
    # two largest also at the other cluster sizes), dense LPs of
    # four, eight and forty columns made from them (the sum over the
    # columns in XLA's order: above 32 its reduce-window of 32; at eight
    # and forty, r in global memory), and the largest backlog four times
    # over (every row array in global memory)
    large_lp, base_lp = relax.build_lp(padded), relax.build_lp(base)
    kernel = check_relax_lp(device, [
        ("drain_large_scale", large_lp, 32, True, (1, 2, 4)),
        ("whatif_baseline", base_lp, 32, True, (1, 2, 4)),
        ("relax tier S=32", stacked, 32, True, ()),
        ("whatif_baseline dense F=4",
         scenarios.dense_relax_lp(base_lp, 4, 4), 32, True, ()),
        ("drain_large_scale dense F=8",
         scenarios.dense_relax_lp(large_lp, 8, 8), 32, True, ()),
        ("whatif_baseline dense F=40",
         scenarios.dense_relax_lp(base_lp, 40, 40), 32, True, ()),
        ("drain_large_scale x4", _repeated_lp(large_lp, 4), 32, False,
         ())])

    # (b) the arm at full width
    launches = 0
    cuda_relax.reset_counts()
    _reset_launches()
    _settle()
    t0 = time.monotonic()
    plan, stats = relax.solve_relaxed(padded, device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    arm_launches = cuda_relax.relax_lp.launches
    launches += _launches()
    lp = relax.build_lp(padded)
    sel = relax.rounded_support(stats.x, padded, lp.live)
    exact = tuple(a.cpu().numpy() for a in large_exact)
    rec = {"live": stats.live, "support": stats.support,
           "support_padded": stats.support_padded,
           "support_digest": hashlib.sha256(
               np.ascontiguousarray(sel).tobytes()).hexdigest(),
           "repair_rounds": stats.repair_rounds,
           "admitted": int(plan[0].sum()), "plan_digest": plan_digest(plan),
           "plans_agree": bool(relax.plans_agree(plan, exact,
                                                 len(exact[0]) - 1))}
    if rec != RELAX_REFERENCE["relax_arm"] or arm_launches != 1:
        raise AssertionError(f"relax arm: {rec}, {arm_launches} relax_lp "
                             f"launches; expected "
                             f"{RELAX_REFERENCE['relax_arm']} and 1")
    out["arm"] = {"wall_s": wall, "lp_seconds": stats.lp_seconds,
                  "repair_seconds": stats.repair_seconds,
                  "support": stats.support, "repair_rounds":
                      stats.repair_rounds}
    print(f"[relax] (b) solve_relaxed on the large-scale backlog "
          f"({padded.wl_cqid.shape[0]} rows, C = {padded.n_cqs}): the JAX "
          f"record (support {stats.support} padded to "
          f"{stats.support_padded}, {stats.repair_rounds} repair rounds, "
          f"{rec['admitted']} admitted, plans_agree with phase 16 (c)'s "
          f"exact plan: {rec['plans_agree']}); 1 relax_lp launch; "
          f"lp_seconds {stats.lp_seconds:.3f}, repair_seconds "
          f"{stats.repair_seconds:.3f}, wall {wall:.3f} ({smi})")

    # (c) bench.py's relax churn through the router: every drain
    # audited, then the arm serving drains 2, 4 and 5
    churn_launches = 0
    for key, audit_every in (("churn", 1), ("churn_served", 3)):
        rec, results, wall, n = _relax_churn(audit_every)
        churn_launches += n
        launches += _launches()
        if key == "churn_served":
            # the served drain 2 synced the exact arm's resident state,
            # and the audited drain 3 solved on it without an upload
            dev = results[1].device
            if (dev.get("delta_updates", 0) + dev.get("donated_full_syncs", 0)
                    != 1 or results[2].device.get("full_uploads") != 0):
                raise AssertionError(f"relax churn: served drain 2 device "
                                     f"{dev}, drain 3 "
                                     f"{results[2].device}")
        phases = collections.Counter()
        for r in results:
            phases.update(r.phases)
        out[key] = {"audit_every": audit_every, "wall_s": wall,
                    "phases_s": dict(phases)}
        print(f"[relax] (c) churn through the router, relax_audit_every "
              f"{audit_every}: the JAX record ({rec['served']} drains "
              f"served, {rec['audit_match']} audited drains agree, "
              f"{rec['oracle_rejections']} oracle rejections, digest "
              f"{rec['digest'][:16]}); {n} relax_lp launches; "
              f"wall {wall:.3f} s, phases "
              f"{json.dumps({k: round(v, 3) for k, v in phases.items()})} "
              f"({smi})")

    # (d) the relax tier over 32 whatif worlds
    cuda_relax.relax_lp.launches = 0
    _reset_launches()
    _settle()
    result = sim.solve_scenarios_relax(bench, overlays)
    torch.cuda.synchronize()
    tier_launches = cuda_relax.relax_lp.launches
    launches += _launches()
    rec = {"scenarios": len(overlays),
           "plan_digest": plan_digest((result.admitted, result.opt,
                                       result.admit_round, result.parked,
                                       result.rounds, result.usage)),
           "admitted": [int(a.sum()) for a in result.admitted],
           "rounds": [int(r) for r in result.rounds]}
    if rec != RELAX_REFERENCE["relax_tier"] or tier_launches != 1:
        raise AssertionError(f"relax tier: {rec}, {tier_launches} relax_lp "
                             f"launches; expected "
                             f"{RELAX_REFERENCE['relax_tier']} and 1")
    out["tier"] = {"solve_seconds": result.solve_seconds,
                   "scenarios_per_s": len(overlays) / result.solve_seconds}
    print(f"[relax] (d) relax tier: the JAX plans of {len(overlays)} "
          f"scenarios in 1 relax_lp launch; {result.solve_seconds:.3f} s, "
          f"{len(overlays) / result.solve_seconds:.1f} scenarios/s ({smi})")
    if launches:
        raise AssertionError(f"relax: {launches} TAS kernel launches; "
                             f"expected 0")
    kernel["launches"] = arm_launches + churn_launches + tier_launches
    kernel["launches_by_path"] = {"relax_arm": arm_launches,
                                  "relax_churn": churn_launches,
                                  "relax_tier": tier_launches}
    kernel["scenarios_by_tier_launch"] = len(overlays)
    # the main path's launches (b)-(d) by cluster size and layout
    kernel["launches_by_cluster"] = {
        str(k): v for k, v in sorted(cuda_relax.relax_lp.clusters.items())}
    kernel["launches_by_layout"] = dict(cuda_relax.relax_lp.layouts)
    return out, kernel, launches


#: the JAX package's records of phase 19 (``JAX_PLATFORMS=cpu python
#: tests/torch_fullsweep_pins.py``)
FULLSWEEP_REFERENCE = {
    "fullsweep": {
        "plan_digest": ("0da5fcc552275f5582c39cdc96b81a63"
            "0d8bdf38e41be98c9e96cb660b6a916c"),
        "tier": ["full"] * 64,
        "rounds": [
            15, 7, 12, 15, 15, 15, 15, 15, 15, 7, 12, 15, 15, 15, 15, 15,
            15, 7, 12, 15, 15, 15, 15, 15, 15, 7, 12, 15, 15, 15, 15, 15,
            15, 7, 12, 15, 15, 15, 15, 15, 65, 62, 72, 65, 65, 65, 65, 65,
            54, 15, 50, 54, 54, 54, 54, 54, 15, 7, 12, 15, 15, 15, 15, 15
        ],
        "admitted": [
            102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102,
            102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102,
            102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102,
            102, 109, 86, 105, 109, 109, 109, 109, 109, 125, 108, 118, 125,
            125, 125, 125, 125, 102, 102, 102, 102, 102, 102, 102, 102
        ],
        "preemptions": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 60, 61,
            65, 60, 60, 60, 60, 60, 52, 14, 39, 52, 52, 52, 52, 52, 0, 0, 0,
            0, 0, 0, 0, 0
        ],
    },
    "tiered": {
        "retier_idx": [
            32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47,
            48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63
        ],
        "retier_reason": "sweep_above_full_cap",
        "plan_digest": ("0b3ba02339639c46e89d28a966738934"
            "9156f41426a082ecfd76ff056a168539"),
        "tier": ["full"] * 32 + ["relax"] * 32,
        "rounds": [
            15, 7, 12, 15, 15, 15, 15, 15, 15, 7, 12, 15, 15, 15, 15, 15,
            15, 7, 12, 15, 15, 15, 15, 15, 15, 7, 12, 15, 15, 15, 15, 15, 5,
            5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 5, 5, 5, 5,
            5, 5, 5, 5, 5, 5, 5, 5, 5, 5
        ],
        "admitted": [
            102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102,
            102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102, 102,
            102, 102, 102, 102, 102, 102, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 10, 9, 8, 10, 10, 10, 10, 10, 0, 0, 0, 0, 0, 0,
            0, 0
        ],
        "preemptions": [0] * 64,
    },
    "all_relax": {
        "plan_digest": ("f06acbde9f5ee77da12c377dbd83a1ee"
            "72984a06625eeef83a046c31e666b059"),
        "tier": ["relax"] * 64,
        "rounds": [5] * 49 + [6] * 1 + [5] * 14,
        "admitted": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 10, 9, 8, 10, 10, 10, 10, 10, 0, 0, 0, 0, 0,
            0, 0, 0
        ],
        "preemptions": [0] * 64,
    },
    "engine": {
        "syncs": ["full", "scatter", "reuse"],
        "runs": [
            {
                "canonical_sha256": ("da06eab2879d0c5b8b979bde6791720b"
                    "6b2c42a565eb4d120e31c791f331c5d4"),
                "rounds": [5] * 4, "admitted": [30] * 4,
                "preemptions": [0] * 4, "tier": ["full"] * 4,
                "parity": {"checked": 2, "identical": True,
                           "mismatches": []},
            },
            {
                "canonical_sha256": ("38367171f0f3715f6579fb1038487222"
                    "b5d66a3e393dd25aadd2512f98779cf5"),
                "rounds": [5] * 4, "admitted": [30] * 4,
                "preemptions": [0] * 4, "tier": ["full"] * 4,
                "parity": {"checked": 0, "identical": True,
                           "mismatches": []},
            },
            {
                "canonical_sha256": ("38367171f0f3715f6579fb1038487222"
                    "b5d66a3e393dd25aadd2512f98779cf5"),
                "rounds": [5] * 4, "admitted": [30] * 4,
                "preemptions": [0] * 4, "tier": ["full"] * 4,
                "parity": {"checked": 0, "identical": True,
                           "mismatches": []},
            },
        ],
    },
}
#: phase 19's worlds (tests/torch_fullsweep_pins.py): bench.py's
#: fullsweep grid cycled to 64, its trace length and forced chunk width,
#: the engine's share of removed workloads and its worlds (the first of
#: 17 (b)'s grid)
FULLSWEEP_QUOTA = (0.25, 0.4, 0.5, 0.75, 1.5, 2.0)
FULLSWEEP_ARRIVAL = (0.5, 0.75, 1.25, 1.5, 2.0, 2.5, 3.0)
FULLSWEEP_S = 64
FULLSWEEP_JOBS = 256
FULLSWEEP_CHUNK = 8
ENGINE_REMOVED = 0.005
ENGINE_WORLDS = 4
FULL_FIELDS = ("admitted", "opt", "admit_round", "parked", "rounds",
               "usage", "wl_usage", "victim_reason")


def _admit(store, wl, cq: str, flavors: dict, now: float) -> None:
    """Admit ``wl`` into ``cq``, each podset under ``flavors``."""
    from kueue_oss_tpu_torch.api import types

    wl.status.admission = types.Admission(
        cluster_queue=cq,
        podset_assignments=[types.PodSetAssignment(
            name=ps.name,
            flavors={r: f for r, f in flavors.items() if r in ps.requests},
            resource_usage={r: q * ps.count
                            for r, q in ps.requests.items()},
            count=1) for ps in wl.podsets])
    wl.set_condition(types.WorkloadConditionType.QUOTA_RESERVED, True,
                     reason="QuotaReserved", now=now)
    store.update_workload(wl)


def fullsweep_problem(n_jobs: int = FULLSWEEP_JOBS):
    """bench.py's fullsweep shape: ``philly_trace(n_jobs, seed=11)`` as a
    contended store (capacity 0.25 of the demand), its earliest 40%
    admitted, exported with the admitted rows and padded; its 64 worlds
    and their skew-aware order. Returns (problem, real workloads, specs,
    overlays, order)."""
    from kueue_oss_tpu_torch import sim
    from kueue_oss_tpu_torch.solver import tensors

    jobs = sim.philly_trace(n_jobs, seed=11)
    store = sim.store_from_trace(jobs, capacity_frac=0.25)
    for j in sorted(jobs, key=lambda j: j.submit_s)[:int(n_jobs * 0.4)]:
        _admit(store, store.workloads[f"default/{j.job_id}"], j.vc,
               {"gpu": "gpu"}, j.submit_s)
    problem = tensors.export_problem(
        store, sim.pending_backlog(store),
        cache=tensors.ExportCache(store, subscribe=False),
        include_admitted=True)
    W = problem.n_workloads
    problem = tensors.pad_workloads(problem, tensors.pow2(W))
    grid = sim.cross(sim.quota_sweep(FULLSWEEP_QUOTA),
                     sim.arrival_sweep(FULLSWEEP_ARRIVAL))
    specs = (grid * (FULLSWEEP_S // len(grid) + 1))[:FULLSWEEP_S]
    return (problem, W, specs, [s.overlay(problem) for s in specs],
            sim.sweep_order(specs))


def _sweep_record(res, n_real: int) -> dict:
    return {"plan_digest": plan_digest([getattr(res, f)
                                        for f in FULL_FIELDS]),
            "tier": list(res.tier),
            "rounds": [int(r) for r in res.rounds],
            "admitted": [int(a[:n_real].sum()) for a in res.admitted],
            "preemptions": [res.preemptions(i, n_real)
                            for i in range(len(res.tier))]}


def _engine_removed(store, share: float = ENGINE_REMOVED) -> list:
    """The keys of the pending workloads removed between runs 1 and 2:
    ``share`` of them (at least one), every (total // n)-th by key, each
    leaving another pending workload of its queue, priority and requests
    behind (its scheduling-equivalence class stays, so the export keeps
    its shapes and the resident session syncs by scatter)."""
    pending = sorted(k for k, w in store.workloads.items()
                     if w.status.admission is None)
    n = max(1, round(len(pending) * share))

    def kind(w):
        return (w.queue_name, w.priority,
                tuple((ps.count, tuple(sorted(ps.requests.items())))
                      for ps in w.podsets))

    left = collections.Counter(kind(store.workloads[k]) for k in pending)
    out = []
    for k in pending[::max(1, len(pending) // n)] + pending:
        c = kind(store.workloads[k])
        if len(out) < n and k not in out and left[c] > 1:
            left[c] -= 1
            out.append(k)
    return out


def _engine_record(report) -> dict:
    import hashlib

    return {"canonical_sha256": hashlib.sha256(
                report.canonical_json().encode()).hexdigest(),
            "rounds": [s["rounds"] for s in report.scenarios],
            "admitted": [s["admitted"] for s in report.scenarios],
            "preemptions": [s["preemptions"] for s in report.scenarios],
            "tier": [s["tier"] for s in report.scenarios],
            "parity": report.parity}


def _check(name: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{name}: {got}; expected {want}")


def fullsweep_phase(smi: str, device: str = "cuda") -> tuple:
    """Phase 19: the FULL what-if sweep. (a) bench.py's fullsweep shape
    in one dispatch and at a chunk width of 8, each against the
    sequential FULL oracle on the first scenario of every width-8 chunk
    and the JAX pins; (b) the tiered sweep on (a)'s problem (rows 32-63
    re-tiered by the FULL cap, and every row by a budget below one
    scenario); (c) ``WhatIfEngine(resident=True).run(full=True)`` on the
    baseline backlog through its full, scatter and reuse syncs. Returns
    (report, TAS kernel launches, relax_lp launches). ``device`` other
    than the card is for rehearsals."""
    import torch

    from kueue_oss_tpu_torch import sim
    from kueue_oss_tpu_torch.config import SimulatorConfig
    from kueue_oss_tpu_torch.perf import generate, generator
    from kueue_oss_tpu_torch.solver import cuda_relax
    from kueue_oss_tpu_torch.solver.full_kernels import to_device_full

    ref = FULLSWEEP_REFERENCE
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}
    launches = relax_launches = 0

    # (a) 64 worlds of bench.py's fullsweep shape
    problem, W, specs, overlays, order = fullsweep_problem()
    caps = sim.full_caps(problem)
    t_full = to_device_full(problem, device)
    _reset_launches()
    cuda_relax.relax_lp.launches = 0
    _settle()
    runs = {}
    for chunk in (0, FULLSWEEP_CHUNK):
        res = sim.solve_scenarios_full(problem, overlays, *caps,
                                       tensors=t_full, chunk=chunk,
                                       order=order)
        _check(f"fullsweep chunk={chunk}", _sweep_record(res, W),
               ref["fullsweep"])
        runs[chunk] = res
    first = [order[k] for k in range(0, FULLSWEEP_S, FULLSWEEP_CHUNK)]
    seq = sim.solve_scenarios_sequential_full(
        problem, [overlays[i] for i in first], *caps, tensors=t_full)
    sync()
    launches += _launches()
    relax_launches += cuda_relax.relax_lp.launches
    for chunk, res in runs.items():
        pr = sim.check_parity_full(res, seq, first)
        if not pr.identical:
            raise AssertionError(f"fullsweep chunk={chunk}: differs from "
                                 f"the sequential oracle "
                                 f"{pr.mismatches[:4]}")
    rec = _sweep_record(runs[0], W)
    out["fullsweep"] = {
        "workloads": W, "padded": problem.n_workloads, "caps": list(caps),
        "scenarios": len(overlays),
        "max_rounds": max(rec["rounds"]), "rounds_sum": sum(rec["rounds"]),
        "preemptions": sum(rec["preemptions"]),
        **{f"chunk{c}": {"wall_s": r.solve_seconds,
                         "host_reads": r.host_reads,
                         "chunks": r.chunk_stats}
           for c, r in runs.items()},
        "sequential": {"scenarios": len(first),
                       "wall_s": seq.solve_seconds,
                       "s_per_scenario": seq.solve_seconds / len(first),
                       "host_reads": seq.host_reads}}
    print(f"[fullsweep] (a) {len(overlays)} worlds x {W} workloads "
          f"(padded {problem.n_workloads}) caps {caps}: one dispatch "
          f"{runs[0].solve_seconds:.3f} s ({runs[0].host_reads} host "
          f"reads), chunks of {FULLSWEEP_CHUNK} "
          f"{runs[FULLSWEEP_CHUNK].solve_seconds:.3f} s "
          f"({runs[FULLSWEEP_CHUNK].host_reads} host reads); rounds max "
          f"{max(rec['rounds'])} sum {sum(rec['rounds'])}, "
          f"{sum(rec['preemptions'])} preemptions; both equal the "
          f"sequential oracle on {len(first)} worlds "
          f"({seq.solve_seconds / len(first):.3f} s a world) and the JAX "
          f"plan digest {rec['plan_digest'][:16]} ({smi})")

    # (b) the tiers on (a)'s problem
    _reset_launches()
    cuda_relax.relax_lp.launches = 0
    _settle()
    tiered = sim.solve_scenarios_tiered(
        problem, overlays, budget=sim.LaneBudget(max_full_scenarios=32),
        caps=caps, tensors=t_full, order=order)
    tier_launches = cuda_relax.relax_lp.launches
    if (tiered.retier_idx != list(range(32, FULLSWEEP_S))
            or tiered.retier_reason != "sweep_above_full_cap"
            or tiered.tier != ["full"] * 32 + ["relax"] * 32
            or tier_launches != on_card):
        raise AssertionError(f"tiers: retier {tiered.retier_reason} "
                             f"{tiered.retier_idx}, tiers {tiered.tier}, "
                             f"{tier_launches} relax_lp launches")
    for name in FULL_FIELDS:
        a = getattr(tiered, name)[:32]
        if not (a == getattr(runs[0], name)[:32]).all():
            raise AssertionError(f"tiers: FULL row {name} differs from (a)")
    _check("tiered", {"retier_idx": list(tiered.retier_idx),
                      "retier_reason": tiered.retier_reason,
                      **_sweep_record(tiered, W)}, ref["tiered"])
    small = sim.solve_scenarios_tiered(
        problem, overlays, budget=sim.LaneBudget(budget_bytes=1),
        caps=caps, tensors=t_full, order=order)
    sync()
    tier_launches = cuda_relax.relax_lp.launches
    launches += _launches()
    relax_launches += tier_launches
    if (small.tier != ["relax"] * FULLSWEEP_S
            or tier_launches != 2 * on_card
            or small.retier_reason != "scenario_exceeds_lane_budget"):
        raise AssertionError(f"tiers: a budget below one world gave "
                             f"{small.retier_reason}, {small.tier}, "
                             f"{tier_launches} relax_lp launches")
    _check("all relax", _sweep_record(small, W), ref["all_relax"])
    out["tiers"] = {"cap32_s": tiered.solve_seconds,
                    "all_relax_s": small.solve_seconds,
                    "relax_lp_launches": tier_launches}
    print(f"[fullsweep] (b) LaneBudget(max_full_scenarios=32): rows "
          f"32-63 re-tiered (sweep_above_full_cap), the FULL rows (a)'s; "
          f"{tiered.solve_seconds:.3f} s; a budget below one world: all "
          f"64 rows relax, {small.solve_seconds:.3f} s; the JAX plans; "
          f"{tier_launches} relax_lp launches ({smi})")

    # (c) the resident engine on the baseline backlog, 15,000 pending
    store, schedule = generate(generator.GeneratorConfig.baseline())
    for i, g in enumerate(schedule):
        # uids 1, 2, ... as the pins' fresh process draws them (the
        # generator's counter is the process's; the uid breaks ties)
        g.workload.uid = i + 1
        store.add_workload(g.workload)
    specs = sim.cross(sim.quota_sweep(WHATIF_QUOTA),
                      sim.arrival_sweep(WHATIF_ARRIVAL))[:ENGINE_WORLDS]
    engine = sim.WhatIfEngine(store, config=SimulatorConfig(
        full_kernel=True), resident=True, device=device)
    _reset_launches()
    cuda_relax.relax_lp.launches = 0
    _settle()
    reports, syncs, walls, stats = [], [], [], []
    removed = []
    for k, par in enumerate((2, 0, 0)):
        if k == 1:
            removed = _engine_removed(store)
            for key in removed:
                store.delete_workload(key)
        t0 = time.monotonic()
        reports.append(engine.run(specs, parity=par))
        sync()
        walls.append(time.monotonic() - t0)
        syncs.append(engine.resident.last_sync)
        stats.append(engine.resident.stats())
    launches += _launches()
    relax_launches += cuda_relax.relax_lp.launches
    recs = [_engine_record(r) for r in reports]
    if (syncs != ["full", "scatter", "reuse"]
            or len(removed) != round(len(schedule) * ENGINE_REMOVED)
            or not all(r["parity"]["identical"] for r in recs)):
        raise AssertionError(f"engine: syncs {syncs}, {len(removed)} "
                             f"removed, parity "
                             f"{[r['parity'] for r in recs]}")
    _check("engine", {"syncs": syncs, "runs": recs}, ref["engine"])
    rep = reports[0]
    out["engine"] = {
        "workloads": rep.base["workloads"],
        "padded": rep.base["padded_workloads"],
        "full_caps": rep.base["full_caps"], "walls_s": walls,
        "removed": len(removed), "syncs": syncs, "resident": stats,
        "runs": [{k: r.timing[k] for k in (
            "solve_seconds", "parity_seconds", "full_chunks",
            "batch_dispatches", "host_reads")} for r in reports],
        "max_rounds": max(recs[0]["rounds"]),
        "preemptions": sum(recs[0]["preemptions"])}
    print(f"[fullsweep] (c) WhatIfEngine(resident=True) on the baseline "
          f"backlog ({rep.base['workloads']} workloads, padded "
          f"{rep.base['padded_workloads']}, caps "
          f"{json.dumps(rep.base['full_caps'])}): {len(specs)} worlds in "
          f"chunks {rep.timing['full_chunks']}, rounds max "
          f"{max(recs[0]['rounds'])}, {sum(recs[0]['preemptions'])} "
          f"preemptions, parity identical on 2; {len(removed)} removed; "
          f"syncs {syncs}; walls "
          f"{json.dumps([round(w, 3) for w in walls])} s; the JAX reports "
          f"({recs[0]['canonical_sha256'][:16]}) ({smi})")
    if launches:
        raise AssertionError(f"fullsweep: {launches} TAS kernel launches; "
                             f"expected 0")
    return out, launches, relax_launches


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
    # the verify oracle is host C++ (g++), built here so that no drain
    # pays for its build
    from kueue_oss_tpu_torch import native

    t0 = time.monotonic()
    if native.load() is None:
        raise RuntimeError("the verify oracle did not build with g++")
    print(f"[build] {native.library_path().name} in "
          f"{time.monotonic() - t0:.3f} s")

    # 3. kernel vs plain
    device = torch.device("cuda")
    reports = [check_leaf_states(device), check_tas_place(device),
               check_fill_counts(device)]

    # 4. stepwise placement, for the placement phase before the kernel
    step_phases, (step_tree, step_batch) = drain_with_stepwise_placer(
        device)

    # 5. main path at full size
    from kueue_oss_tpu_torch.solver.engine import SolverEngine

    t0 = time.monotonic()
    store, queues = _drain_store()
    engine = relax_off(SolverEngine(store, queues))
    setup_s = time.monotonic() - t0
    _reset_launches()
    cuda_tas.tas_place_sequential.steps = 0
    _settle()
    t0 = time.monotonic()
    result = engine.drain(now=0.0)
    torch.cuda.synchronize()
    drain_s = time.monotonic() - t0
    leaf_launches = cuda_tas.leaf_states.launches
    place_launches = cuda_tas.tas_place_sequential.launches
    fill_lean = cuda_tas.launch_counts["fill_counts"]
    steps = cuda_tas.tas_place_sequential.steps
    placed = _placed(store, result)
    if (leaf_launches != 0 or fill_lean != 0 or place_launches != 1
            or steps != placed):
        raise AssertionError(
            f"main path: {place_launches} tas_place_sequential launches "
            f"({steps} steps), {leaf_launches} leaf_states and "
            f"{fill_lean} fill_counts launches for {placed} placements; "
            f"expected 1 ({placed}), 0 and 0")
    check_plan(store, queues, result)
    if (result.frame is None or result.frame.full_reason != "first_sync"
            or result.device.get("full_uploads") != 1):
        raise AssertionError(f"main path: session frame {result.frame}, "
                             f"device {result.device}; expected the "
                             f"sessions' first sync")
    replay_err = _check_place("the drain's placement batch", step_tree,
                              list(step_batch))
    print(f"[main] 1 tas_place_sequential launch, {steps} steps, "
          f"0 leaf_states and 0 fill_counts launches; the drain's batch agrees exactly "
          f"(max abs err {replay_err}); sessions on: first_sync, "
          f"{result.device['full_upload_bytes']} bytes uploaded")
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

    # 11-13. the scheduler: the storm, the TAS store, a refused backlog
    sched_storm, sched_storm_launches = scheduler_storm()
    sched_tas, sched_tas_launches, sched_tas_leaf = scheduler_tas()
    sched_refused, sched_refused_launches = scheduler_refused()

    # 14. the scheduler's host TAS placement and its device fill
    sched_host, host_fill, host_leaf, host_place = scheduler_tas_host()

    # 15. streaming admission: micro-drains through the lean drain on
    # the card, and serve with its watch-driven worker
    stream_fleets, stream_launches = streaming_fleets()
    stream_serve = streaming_serve()

    # 16. the perf runner: Kueue's baseline run host only and auto, and
    # drain_benchmark at the large-scale size
    perf, perf_launches, (large_store, large_plan) = perf_runner(smi)

    # 17. the what-if sweep: bench.py's shape batched, and the engine on
    # the baseline backlog
    whatif, whatif_launches = whatif_sweeps(smi)

    # 18. the relaxed arm: its kernel against the plain loop, the arm on
    # the large-scale backlog, the router's audited churn, the relax tier
    from kueue_oss_tpu_torch.solver import cuda_relax

    if cuda_relax.relax_lp.launches:
        raise AssertionError(f"phases 1-17 launched relax_lp "
                             f"{cuda_relax.relax_lp.launches} times; the "
                             f"arm is pinned off there")
    relaxed, relax_report, relax_launches = relax_phase(
        smi, large_store, large_plan)
    reports.append(relax_report)

    # 19. the FULL what-if sweep: the scenario-batched preemption drain,
    # lane-budgeted chunks with the relax tier, resident sweep state
    fullsweep, fullsweep_launches, fullsweep_relax = fullsweep_phase(
        smi)
    relax_report["launches"] += fullsweep_relax
    relax_report["launches_by_path"]["fullsweep"] = fullsweep_relax
    # the fill's own path: phase 14's host placement with the fill gate
    # on; every other path launched no TAS kernel but its placer
    reports[2]["launches"] = host_fill
    reports[2]["launches_path"] = "scheduler_tas_host"
    reports[2]["scheduler_tas_host_tile"] = sched_host["fill_tile"]
    reports[2]["fill_over_rollup_ms"] = sched_host["fill_over_rollup_ms"]
    reports[2]["launches_by_path"] = {"tas_lean": fill_lean,
                                      "tas_full": 0, "storm_full": 0,
                                      "fair_storm": fair_launches,
                                      "afs": afs_launches,
                                      "storm_churn": churn_launches,
                                      "scheduler_storm":
                                          sched_storm_launches,
                                      "scheduler_tas": 0,
                                      "scheduler_refused":
                                          sched_refused_launches,
                                      "scheduler_tas_host": host_fill,
                                      "streaming": stream_launches,
                                      "perf_runner": perf_launches,
                                      "whatif": whatif_launches,
                                      "relax": relax_launches,
                                      "fullsweep": fullsweep_launches}
    reports[0]["launches_by_path"] = {"tas_lean": leaf_launches,
                                      "tas_full": 0, "storm_full": 0,
                                      "fair_storm": fair_launches,
                                      "afs": afs_launches,
                                      "storm_churn": churn_launches,
                                      "scheduler_storm":
                                          sched_storm_launches,
                                      "scheduler_tas": sched_tas_leaf,
                                      "scheduler_refused":
                                          sched_refused_launches,
                                      "scheduler_tas_host": host_leaf,
                                      "streaming": stream_launches,
                                      "perf_runner": perf_launches,
                                      "whatif": whatif_launches,
                                      "relax": relax_launches,
                                      "fullsweep": fullsweep_launches}
    # leaf_states is on no main path since fill_counts took the fill
    # (its launches on every path are 0, checked above)
    reports[0]["launches"] = sum(reports[0]["launches_by_path"].values())
    reports[0]["launches_path"] = None
    reports[1]["launches_path"] = "tas_lean"
    reports[0]["scheduler_tas_host_tile"] = sched_host["leaf_tile"]
    reports[1]["launches_by_path"] = {"tas_lean": place_launches,
                                      "tas_full": tas_full_launches,
                                      "storm_full": 0,
                                      "fair_storm": fair_launches,
                                      "afs": afs_launches,
                                      "storm_churn": churn_launches,
                                      "scheduler_storm":
                                          sched_storm_launches,
                                      "scheduler_tas": sched_tas_launches,
                                      "scheduler_refused":
                                          sched_refused_launches,
                                      "scheduler_tas_host": host_place,
                                      "streaming": stream_launches,
                                      "perf_runner": perf_launches,
                                      "whatif": whatif_launches,
                                      "relax": relax_launches,
                                      "fullsweep": fullsweep_launches}

    timings = {"setup_s": setup_s, "drain_s": drain_s,
               **{f"{k}_s": v for k, v in result.phases.items()},
               "rounds": result.rounds, "admitted": result.admitted,
               "stepwise_placer": step_phases, "storm": storm,
               "tas_full": tas_full, "fair_storm": fair, "afs": afs,
               "storm_churn": churn, "scheduler_storm": sched_storm,
               "scheduler_tas": sched_tas,
               "scheduler_refused": sched_refused,
               "scheduler_tas_host": sched_host,
               "streaming": stream_fleets, "streaming_serve": stream_serve,
               "perf_runner": perf, "whatif": whatif, "relax": relaxed,
               "fullsweep": fullsweep}
    print("[timings] " + json.dumps(timings))
    print(smi)
    print(json.dumps({"kernels": reports}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

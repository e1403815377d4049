#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (kueue_oss_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

(``python3 chip_smoke.py --phase 20`` runs phases 1, 2 and 20 alone,
with phase 14's host-only store built afresh for 20 (c);
``python3 chip_smoke.py --phase 21`` runs phases 1, 2 and 21 alone, and
``--phase 22`` phases 1, 2 and 22; none prints a kernel report.)

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
   both engines. Then a light churn: three cycles that lower the
   priority of the newest 0.5% of the pending workloads in place
   (bench.py's churn rate, without finishes or arrivals, which change
   the backlog's membership and so force an ``assemble`` export): from
   the second cycle the export must ``scatter``, the session emit a
   ``delta`` through its hint advance, and the twin decide alike; both
   engines' encode and device_put seconds are printed.
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
12. scheduler TAS: the phase 5 store at phase 4's depth (its first
   1,500 workloads, which hold all 102 admissions; cut for the script's
   time) through ``Scheduler(solver="auto")``: the JAX scheduler's
   record (102 held, 1,398 parked, one drain, one empty host cycle: no
   host TAS head), phase 4's plan digest and rounds, one
   tas_place_sequential launch placing 102 podsets, no leaf_states
   launch;
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
   cohort) in four ``run_until_quiet(now=100.0, tick=0.001)`` runs: (a)
   ``Scheduler(solver="auto")`` with TASDeviceFillCounts off, (b) the
   same with it on, (c) host-only (``solver=None, device="cuda"``) with
   it on, (d) host-only with it off; (a) and (b) on the store's first
   1,500 workloads (``TAS_MIXED_WORKLOADS``; cut from 15,000 for the
   script's time: the card no longer drains the full mixed store, whose
   slices and leader groups phase 5's 1-pod store lacks), (c) and (d)
   on all 15,000. Each run must equal the JAX scheduler's record (digest, held,
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
   requests 100 cpu) at 128 arrivals a tick for 100 ticks (12,800
   workloads; bench.py runs 400 ticks: cut for the script's time to 200
   and then to 100, one boundary kept), so every
   micro-drain is a 128-entry burst that runs the
   lean drain on the card: the micro-solve twin and the host-walk twin
   (``micro_solve = False``) in step, equal after every micro-drain
   (outcome, the admitted keys' admissions, every queue's heap and
   parked sets) and at every boundary, and a batch twin
   (``streaming=False``); (b) the ``wide`` fleet (multi-flavor and
   borrow-capable cohort ClusterQueues: the flavor-pick witness and the
   reserved-headroom walk on the host, the boundary drains on the card)
   at bench.py's 16 arrivals a tick for 400 ticks (6,400 workloads,
   4 boundaries, uncut), stream and batch twins. Every twin's record (digests at each boundary with and
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
   same at a quarter of its depth (3,750 workloads: cut for the
   script's time) with ``solver="auto"`` on the card, both routing cost
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
   through ``solve_scenarios`` on the card, with the stacked plan's
   digest pinned to the JAX vmapped batch's, against
   ``solve_scenarios_sequential`` on the card with parity on every 16th
   of the 128 (``WHATIF_ORACLE_EVERY``; cut from all 128 for the
   script's time); (b) ``WhatIfEngine(store).run(specs)`` on the
   baseline backlog (15,000 pending at t0) with an 8 x 2 quota x arrival
   grid (cut from 8 x 4: the arrival worlds 0.5 and 0.75, for the
   script's time) and the default ``SimulatorConfig``:
   ``canonical_json()`` byte-identical to the JAX report's (sha256
   pinned: every world's KPIs are the JAX engine's), 2 bucketed
   dispatches, parity with the sequential oracle on the base world (cut
   from the engine's default 2, which adds arrival 0.25's world, for
   the script's time). Per-dispatch walls and host reads are
   printed.
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
   of 32 and a reduce) and, since the sum's order is held up to 1,024
   columns, ``scenarios.interior_relax_lp`` of 200 columns (saturated
   prices, x interior for all 32 iterations: an LP on which the
   windowed order and a plain in-order sum give different x).
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
20. the what-if-scored MultiKueue dispatch and the TAS controllers
   (``multikueue/``, ``sim/dispatch.py``, ``controllers/``, ``chaos``):
   (a) bench.py's phase-2 fleet (bench.py:1851-1990): a hub with the
   MultiKueue admission check over four workers (``tight-a/b/c``,
   ``roomy``), six candidate sizes dispatched by
   ``WhatIfDispatcher(check_oracle=True)`` on the card and by
   ``IncrementalDispatcher``: the times to admit (simulated s), the
   winners and every pricing's report equal the JAX pins, the oracle
   agrees 6/6, no pricer fault; score ms per pricing printed; (b) one
   nomination priced over 8 worker clusters of Kueue's large-scale mix
   without preemption (four at 1 cohort x 10 ClusterQueues, four at
   2 x 5, quotas 0.5-2x; five saturated with 500 pending each, three
   with headroom, their backlogs the arrival-ordered prefixes within
   0.6-0.9 of their quotas; cut from 1,000 ClusterQueues for the
   phase's time) in one batched lean drain, its report the JAX pin
   (a real choice: the headroom workers admit the candidate in
   different rounds, the others park it) and bit for bit the
   sequential oracle's; rounds and host reads
   printed; (c) phase 14's host-only store: 96 seeded nodes flapped
   down (``NodeFlapInjector``), ``NodeFailureController`` past the grace
   period and the recovery timeout with TASDeviceFillCounts on: 29
   workloads re-placed in place through the device fill
   (``fill_counts`` launches > 0), the one on two failed nodes evicted,
   the new assignments and the committed store the JAX pins; (d) the
   TAS drain store at phase 4's 1,500 workloads with an admission check
   on every ClusterQueue: host cycles reserve quota with the topology
   Pending, the checks turn Ready, ``WorkloadReconciler`` queues the
   second pass, which places through the device fill, and admits: the
   committed store the JAX pin; (e) ``simulate_trace`` with two down
   flaps and one up flap on a generated lean trace whose store carries
   the 640 TAS nodes: the flap log, admissions and TTA by class the JAX
   pins. Pins: tests/torch_dispatch_pins.py.
21. the solver sidecar (``solver/service.py``, ``chaos``): (a) phase
   10's sequence (the baseline storm at full size, wave 1, wave 2, 2
   warm-up and 8 measured churn cycles) through ``SolverEngine(store,
   queues, remote=SolverClient(path))`` with ``SolverServer(path)`` in a
   sidecar process started by ``subprocess`` (``python -m
   kueue_oss_tpu_torch.solver.service``) that owns the card: every
   drain's plan ``STORM_CHURN_REFERENCE`` (counts, rounds, digest,
   victims' reasons, the session frame) with phase 6's quota and victim
   checks; on the wire a SYNC for the session's full syncs (the first
   sync and its two dense deltas) and a DELTA for every delta, no
   resync, no failure; ``bytes_by_kind``, the SYNC frame against the
   median DELTA frame and each drain's wall beside phase 10's
   in-process wall printed; (b) phase 12's TAS store at 1,500
   workloads through ``Scheduler(solver="auto", solver_config=
   SolverBackendConfig(socket_path=path))``: phase 12's record, one
   ``tas_place_sequential`` launch in the control plane, no
   unavailable or unsupported fallback; the sidecar process then stops
   and reports no hand-kernel launch of its own; (c) bench.py's chaos
   scenario, not cut (8 ClusterQueues of 32 cpu, 1,024 workloads, the
   seeded ``FaultInjector``), on a ``ChaosSolverServer`` on the card,
   followed by six churn rounds that drive the injector into its
   corrupt plan and weighted mix: the JAX record (seats, cycles, faults
   by kind, rejected plans, backend errors, frames, committed digest),
   every seat held, no ClusterQueue over quota; (d) the breaker drive
   of .claude/skills/verify/SKILL.md: a second sidecar process,
   ``Scheduler(solver="auto", solver_config=...)`` with the cost gates
   reset every round, the sidecar SIGKILLed, host rounds refilling
   every seat while two failures trip the breaker, a round refused with
   no socket attempt while it is open, then a restarted sidecar and the
   cooldown on a fake clock close it with exactly one probe. Pins:
   tests/torch_sidecar_pins.py (c); (a) and (b) hold phases 10 and 12's
   pins.
22. the solver farm (``federation``): (a) bench.py's federation phase 1
   (bench.py:1674-1848), not cut: an in-process ``SolverServer(path,
   device="cuda", max_sessions=16)`` with a ``FarmScheduler`` loaded by
   ``config.load({"federation": ...})``, ``validate`` and
   ``FarmScheduler.from_config`` (weights 2:2:1:1, a 2 ms quantum) and
   wired by ``attach_farm``; 4 tenants x 2 control planes
   (``federation.build_member``, padded to 64) warmed one after
   another, then 5 s of contended churn in 8 threads: zero cross-tenant
   state (every resident session's checksum is its own tenant's host
   session's and no other's), every member's ``plan_fingerprint`` equal
   to a dedicated twin's replaying the same churn in-process on the
   card, then ``ClusterLossInjector.evict_farm_tenant("cp-c")`` (each of
   cp-c's control planes heals with one counted resync, the
   neighbours' sessions are the same objects with the same checksums)
   and ``force_throttle("cp-d")`` (the next drain raises
   ``SolverUnavailable`` on backpressure, the breaker counts it, the
   solve slot is not spent, a host cycle admits the arrival); solves,
   wall shares, the spread of share over weight (printed, not gated:
   DRR fairness is held on the CPU), throttles and grant waits are
   printed; (b) a fleet at real size on one farm, the tenants in
   threads: two control planes on phase 10's storm and churn (weights
   2:1), each drain held to ``STORM_CHURN_REFERENCE``, and one on phase
   12's TAS store through ``Scheduler(solver=<its engine>)``, held to
   phase 12's record, one ``tas_place_sequential`` launch of 102 steps
   in its control plane, read with every other kernel's count (0) after
   the threads join. No hand kernel runs in (a): every count, relax_lp's
   included, is read from (a)'s start (before its server and members
   are built) to its end (after the twins, the heal and the throttle).

Phases 5-15 pin the JAX engine's plans with delta sessions on (its
default, and the port's; ``use_sessions = False`` stays the off
switch, which phase 10's twin runs). The relaxed arm's router decides
by wall clock, so phases 5 and 10-16 pin it off (``relax_off``) on
both sides, and relax_lp must not have launched before phase 18.
Phases 8-11, 13, 15-19, 20 (a), (b) and (e), 21 (a), (c) and (d), and
22 (a) run no TAS flavor: the
TAS kernels' launch counts are set to 0
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
#: engine with ``mesh_mode="off"`` and delta sessions on (its default,
#: and the port's); the sessions re-lay wave 2's rows into stable slots,
#: which orders its evicted keys (and so its digest) as phase 10's wave
#: 2 (``STORM_CHURN_REFERENCE``); phase 7's single drain is the
#: session's first sync (tests/torch_engine_pins.py prints them)
STORM_REFERENCE = [
    {"admitted": 600, "evicted": 0, "rounds": 22, "held": 600,
     "digest": "e127c72662d418820e4abaa29e4e4b0d03ed02f9d7e97c6b59a3aa27"
               "f87fedc9"},
    {"admitted": 30, "evicted": 600, "rounds": 6, "held": 30,
     "digest": "b0fb9ed57388273d10976583bea4859801e80748fa8208f2de95c9a7"
               "821571ef"},
]
#: the JAX package's plans of phases 8 and 9 (its engine without mesh,
#: delta sessions on, as above; they equal its sessions-off plans)
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
     "digest": "d0678ae573b3b68880b6654495dae904"
              "47774ed516d4f3774c371c7a4cf2277d",
     "drains": 1, "unsupported": 0, "drain_admitted": 102,
     "parked": 1398},
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
             "digest": "86f11215556684d169a9d8382386cb54"
                       "a8931edb871c8aa14776f1029d35b0bb",
             "drains": 1, "unsupported": 0, "drain_admitted": 49,
             "parked": 1451, "groups": 0, "fills": 84},
    "auto_fill": {"cycles": 13, "held": 49, "evicted": 0, "reasons": {},
                  "digest": "86f11215556684d169a9d8382386cb54"
                            "a8931edb871c8aa14776f1029d35b0bb",
                  "drains": 1, "unsupported": 0, "drain_admitted": 49,
                  "parked": 1451, "groups": 0, "fills": 84},
    "host_fill": {"cycles": 23, "held": 62, "evicted": 0, "reasons": {},
                  "digest": "f2e3562e733ee8685910b5f15d8cdf37"
                            "bffa8c49bd29b00274a543c28d9638f0",
                  "parked": 14938, "groups": 2, "fills": 385},
    "host": {"cycles": 23, "held": 62, "evicted": 0, "reasons": {},
             "digest": "f2e3562e733ee8685910b5f15d8cdf37"
                       "bffa8c49bd29b00274a543c28d9638f0",
             "parked": 14938, "groups": 2, "fills": 385},
}
#: phase 14's runs: (name, solver="auto", TASDeviceFillCounts on), and
#: each run's depth (tests/torch_scheduler_pins.py's): the auto runs on
#: the store's first 1,500 workloads (cut from 15,000, 23 s each, for
#: the script's time; no phase drains the full 15,000-workload mixed
#: store on the card since)
TAS_MIXED_RUNS = (("auto", True, False), ("auto_fill", True, True),
                  ("host_fill", False, True), ("host", False, False))
TAS_MIXED_WORKLOADS = {"auto": 1500, "auto_fill": 1500,
                       "host_fill": 15000, "host": 15000}
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
]
_SINGLE_BATCH = [
    "4d94d4cae0cea236f434f384fd7e2b98"
    "fb7548c0767107d3150b5ca23884a29d",
]
_SINGLE_COMMITTED = [
    "10d1699048ae4f43c35fb133b0cee789"
    "40fceb0900000f2c0e97b1a1704d921c",
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
            "workloads": 12800, "admitted": 12800, "tta_ms_p50": 10.0,
            "tta_ms_p95": 10.0, "stream_admitted": 12672,
            "micro_entries": 12672, "micro_solves": 99,
            "boundaries": _SINGLE_STREAM, "committed": _SINGLE_COMMITTED},
        "host": {
            "workloads": 12800, "admitted": 12800, "tta_ms_p50": 10.0,
            "tta_ms_p95": 10.0, "stream_admitted": 12672, "micro_entries": 0,
            "micro_solves": 0, "boundaries": _SINGLE_STREAM,
            "committed": _SINGLE_COMMITTED},
        "batch": {
            "workloads": 12800, "admitted": 12800, "tta_ms_p50": 490.0,
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
#: tests/torch_streaming_pins.py's STREAMING_RUNS; the single fleet
#: runs 100 of bench.py's ticks (cut from 200 for the script's time;
#: its record is the first boundary of the longer run's)
STREAMING_RUNS = {"single": (128, 100, ("micro", "host", "batch")),
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
    "auto": {"admitted": 3750, "finished": 3750, "preemptions": 1290,
             "cycles": 211, "sim_wall_ms": 18200,
             "tta_ms_by_class": {"large": 0.0,
                                 "medium": 6338.235294117647,
                                 "small": 12320.454545454546},
             "digest": ("567fac13a0912a6c03c510b792d3b161"
                        "aba8addf25ec168868a0f64152a78cfb"),
             "drains": 19, "unsupported": 0, "drain_admitted": 3930},
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
    "canonical_sha256": "4f760cbc8c98608fa585ac74da459aa5"
                        "8ddf6716b301f176b6627af7fafb12ec",
    "max_rounds": 503, "rounds_sum": 5034, "admitted_sum": 3470,
    "parity": {"checked": 1, "identical": True, "mismatches": []},
    "batch_dispatches": 2,
    "round_buckets": {"128": 8, "512": 8}}
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
#: phase 17's grids: bench.py's whatif sweep, and (b)'s 8 x 2 worlds
#: (cut from 8 x 4 for the script's time: the arrival worlds 0.5 and
#: 0.75, 253 and 378 rounds; the base arrival's 503 rounds and 0.25's
#: 128 stay, two round buckets)
BENCH_QUOTA = (0.25, 0.5, 0.75, 1.25, 1.5, 2.0, 3.0)
BENCH_ARRIVAL = (0.5, 0.75, 1.25, 1.5, 2.0, 2.5, 3.0)
WHATIF_QUOTA = (0.25, 0.5, 0.75, 1.25, 1.5, 2.0, 3.0)
WHATIF_ARRIVAL = (0.25,)
#: phase 17 (a)'s sequential oracle runs every 16th of the 128 scenarios
#: (cut from all 128; the batch's digest still covers all 128), and 17
#: (b)'s on its first world, the base (503 rounds; cut from the default
#: 2, which added arrival 0.25's 128 rounds), for the script's time
WHATIF_ORACLE_EVERY = 16
WHATIF_PARITY = 1
#: phase 16 (b)'s depth: the baseline's per-class counts times this
#: (3,750 workloads; cut from 15,000 for the script's time)
PERF_AUTO_SCALE = 0.25
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


#: phase 10's light churn: cycles that edit LIGHT_SHARE (bench.py's 0.5%
#: churn rate, bench.py:769-800) of the pending workloads in place
LIGHT_CYCLES = 3
LIGHT_SHARE = 0.005


def light_churn_edit(store) -> int:
    """One light-churn cycle's edit: the newest LIGHT_SHARE of the pending
    workloads (by creation time, then name) lose one priority step, in
    place. The backlog's membership stays (no finish, no arrival), so
    the columnar export can scatter the dirty rows and the session take
    its hint advance; a lower priority can start no preemption. Returns
    the workloads edited."""
    pending = sorted((w for w in store.workloads.values()
                      if not w.is_quota_reserved and not w.is_finished),
                     key=lambda w: (w.creation_time, w.name))
    n = max(1, int(len(pending) * LIGHT_SHARE))
    for wl in pending[-n:]:
        wl.priority -= 1
        store.update_workload(wl)
    return n


def _light_churn(sides, t0: float) -> tuple:
    """Phase 10's light churn after the heavy one: LIGHT_CYCLES cycles of
    ``light_churn_edit`` and a drain, on the sessions engine and its
    sessions-off twin, which must decide alike. From the second cycle on
    the sessions engine must export by ``scatter`` (membership unchanged
    since the last export), emit a ``delta`` frame and take the hint
    advance (``fast_advances`` + 1 a cycle). Returns (per-cycle rows with
    both engines' encode and device_put seconds, TAS kernel launches)."""
    import torch

    (_, store, engine), _ = sides
    session = engine._delta_sessions["full"]
    rows, launches = [], 0
    for c in range(1, LIGHT_CYCLES + 1):
        now = t0 + c
        row = {"label": f"light{c}"}
        decisions = None
        for name, st, eng in sides:
            edited = light_churn_edit(st)
            fast0 = session.fast_advances
            _reset_launches()
            _settle()
            t1 = time.monotonic()
            result = eng.drain(now=now)
            torch.cuda.synchronize()
            wall = time.monotonic() - t1
            launches += _launches()
            if _launches():
                raise AssertionError("the storm has no TAS flavor, yet a "
                                     "TAS kernel launched")
            _quota_checks(st)
            if decisions is None:
                decisions = _decisions(st, result)
                frame = _frame_summary(result)
                row.update(frame)
                row["export_mode"] = result.export_stats.get("export_mode")
                row["fast_advances"] = session.fast_advances - fast0
                if c > 1 and (row["export_mode"] != "scatter"
                              or frame["frame"] != "delta"
                              or row["fast_advances"] != 1):
                    raise AssertionError(
                        f"light churn cycle {c}: export "
                        f"{row['export_mode']}, frame {frame['frame']}, "
                        f"{row['fast_advances']} hint advances; expected "
                        f"scatter, delta and 1")
            elif _decisions(st, result) != decisions:
                raise AssertionError(f"light churn cycle {c}: the "
                                     f"sessions-off twin decided otherwise")
            row[name] = {"edited": edited, "drain_s": wall,
                         "admitted": result.admitted,
                         "evicted": result.evicted,
                         **{f"{k}_s": v for k, v in result.phases.items()},
                         **result.device, **result.export_stats}
        rows.append(row)
        print(f"[storm churn light{c}] " + json.dumps(row))
    return rows, launches


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
    light, light_launches = _light_churn(
        (("sessions", store, engine), ("twin", twin_store, twin)),
        STORM_CHURN_REFERENCE[-1]["now"])
    launches += light_launches
    return {"drains": out, "light": light,
            "full_uploads": dev.full_uploads,
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
    """Phase 12: the TAS store at phase 4's depth through
    Scheduler(solver="auto"). Returns (report, tas_place_sequential
    launches, leaf_states launches)."""
    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import plan_digest, tas_drain_store
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_oss_tpu_torch.solver import cuda_tas

    store = tas_drain_store(types, Store, n_workloads=STEPWISE_WORKLOADS)
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
    ref = STEPWISE_REFERENCE
    if (launches != 1 or steps != ref["admitted"] or leaf_launches
            or fill_launches
            or plan_digest(store, drain.admitted_keys) != ref["digest"]
            or drain.rounds != ref["rounds"]
            or rec["parked"] != ref["parked"]
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
          f"{rec['parked']} parked, phase 4's plan digest); 1 "
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
    tas_place_sequential launches, (store, scheduler) of the last run,
    the host-only one with the fill gate off, which phase 20 (c)
    reuses)."""
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
            store = tas_mixed_store(
                types, Store, n_workloads=TAS_MIXED_WORKLOADS[name])
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
            last = (store, sched)
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
    if TAS_MIXED_RUNS[-1] != ("host", False, False):
        raise AssertionError("phase 20 (c) reuses the host-only run")
    return out, fill_total, leaf_total, place_total, last


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
    held = range(0, len(overlays), WHATIF_ORACLE_EVERY)
    seq = sim.solve_scenarios_sequential(problem,
                                         [overlays[i] for i in held])
    launches += _launches()
    parity = sim.check_parity(batch, seq, held)
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
    # the oracle's seconds per scenario over the batch's
    ratio = (seq.solve_seconds / len(held)
             / (again.solve_seconds / len(overlays)))
    out["bench"] = {"batched_s": [batch.solve_seconds, again.solve_seconds],
                    "sequential_s": seq.solve_seconds,
                    "sequential_scenarios": len(held),
                    "scenarios_per_s": len(overlays) / again.solve_seconds,
                    "sequential_over_batched": ratio,
                    "batch_width": batch.batch_width,
                    "host_reads": batch.host_reads,
                    "sequential_host_reads": seq.host_reads}
    print(f"[whatif] (a) bench shape: the JAX plans of 128 scenarios "
          f"(max {rec['max_rounds']} rounds), batched == sequential on "
          f"{len(held)} (every {WHATIF_ORACLE_EVERY}th); batched "
          f"{batch.solve_seconds:.3f} s / {again.solve_seconds:.3f} s "
          f"({batch.host_reads} host reads), "
          f"{len(overlays) / again.solve_seconds:.1f} scenarios/s; "
          f"sequential {seq.solve_seconds:.3f} s for {len(held)} "
          f"({seq.host_reads} host reads), {ratio:.1f}x the batch a "
          f"scenario ({smi})")

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
        report = sim.WhatIfEngine(store).run(specs, parity=WHATIF_PARITY)
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
          f"{json.dumps(dispatches)}, parity identical on "
          f"{WHATIF_PARITY} "
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
    # and forty, r in global memory), an LP of 200 columns whose x stays
    # interior (the windowed and a plain in-order sum give different x
    # there), and the largest backlog four times over (every row array
    # in global memory)
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
        ("whatif_baseline interior F=200",
         scenarios.interior_relax_lp(base_lp, 200, 200), 32, True, ()),
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
#: 19 (c)'s arrival worlds (once 17 (b)'s), with the base quota
ENGINE_ARRIVAL = (0.25, 0.5, 0.75)
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
                      sim.arrival_sweep(ENGINE_ARRIVAL))[:ENGINE_WORLDS]
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



# ---------------------------------------------------------------------------
# 20. the what-if-scored MultiKueue dispatch and the TAS controllers
# ---------------------------------------------------------------------------

#: the JAX package's records of phase 20 (``JAX_PLATFORMS=cpu python
#: tests/torch_dispatch_pins.py`` prints them): (a) bench.py's fleet, (b)
#: the fleet-scale pricing's report, (c) the node-failure leg, (d) the
#: delayed TAS leg, (e) the flap trace
DISPATCH_REFERENCE = json.loads("""
{"bench_fleet": {"whatif": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0], "incremental":
[1.0, 16.0, 16.0, 1.0, 16.0, 16.0], "winners": {"whatif": ["roomy", "roomy",
"roomy", "roomy", "roomy", "roomy"], "incremental": ["tight-a", "roomy",
"roomy", "tight-a", "roomy", "roomy"]}, "reports": [{"best": "roomy",
"scores": [["roomy", true, 0, 0.1625], ["tight-a", true, 0, 0.9],
["tight-b", true, 0, 0.92], ["tight-c", true, 0, 0.95]], "unpriceable": {},
"batch_width": 4, "oracle_best": "roomy", "oracle_identical": true},
{"best": "roomy", "scores": [["roomy", true, 0, 0.5], ["tight-a", false,
1073741824, 0.75], ["tight-b", false, 1073741824, 0.8], ["tight-c", false,
1073741824, 0.8]], "unpriceable": {}, "batch_width": 4, "oracle_best":
"roomy", "oracle_identical": true}, {"best": "roomy", "scores": [["roomy",
true, 0, 0.25], ["tight-a", false, 1073741824, 0.75], ["tight-b", false,
1073741824, 0.8], ["tight-c", false, 1073741824, 0.8]], "unpriceable": {},
"batch_width": 4, "oracle_best": "roomy", "oracle_identical": true},
{"best": "roomy", "scores": [["roomy", true, 0, 0.1625], ["tight-a", true,
0, 0.9], ["tight-b", true, 0, 0.92], ["tight-c", true, 0, 0.95]],
"unpriceable": {}, "batch_width": 4, "oracle_best": "roomy",
"oracle_identical": true}, {"best": "roomy", "scores": [["roomy", true, 0,
0.4375], ["tight-a", false, 1073741824, 0.75], ["tight-b", false,
1073741824, 0.8], ["tight-c", false, 1073741824, 0.8]], "unpriceable": {},
"batch_width": 4, "oracle_best": "roomy", "oracle_identical": true},
{"best": "roomy", "scores": [["roomy", true, 0, 0.3125], ["tight-a", false,
1073741824, 0.75], ["tight-b", false, 1073741824, 0.8], ["tight-c", false,
1073741824, 0.8]], "unpriceable": {}, "batch_width": 4, "oracle_best":
"roomy", "oracle_identical": true}], "agree": 6, "scored": 6}, "fleet":
{"best": "w5", "scores": [["w5", true, 3, 0.6114285714285714], ["w4", true,
4, 0.9166666666666666], ["w6", true, 7, 0.7625], ["w0", false, 1073741824,
1.0], ["w1", false, 1073741824, 1.0], ["w2", false, 1073741824, 1.0], ["w3",
false, 1073741824, 1.0], ["w7", false, 1073741824, 1.0]], "unpriceable": {},
"batch_width": 8, "oracle_best": "w5", "oracle_identical": true},
"node_failure": {"down": ["n-0-0", "n-0-10", "n-0-11", "n-0-23", "n-0-28",
"n-0-4", "n-0-42", "n-0-62", "n-0-7", "n-1-1", "n-1-22", "n-1-23", "n-1-24",
"n-1-29", "n-1-3", "n-1-42", "n-1-6", "n-1-8", "n-2-20", "n-2-22", "n-2-3",
"n-2-48", "n-2-49", "n-2-50", "n-2-56", "n-2-57", "n-2-60", "n-2-63",
"n-3-23", "n-3-28", "n-3-29", "n-3-36", "n-3-42", "n-3-52", "n-3-53",
"n-3-57", "n-3-60", "n-3-7", "n-4-11", "n-4-14", "n-4-25", "n-4-26",
"n-4-33", "n-4-36", "n-4-40", "n-4-5", "n-4-50", "n-4-51", "n-4-54",
"n-4-55", "n-4-57", "n-5-2", "n-5-23", "n-5-39", "n-5-41", "n-5-48",
"n-5-57", "n-5-63", "n-5-8", "n-6-0", "n-6-13", "n-6-18", "n-6-22",
"n-6-24", "n-6-28", "n-6-39", "n-6-48", "n-6-61", "n-6-63", "n-7-22",
"n-7-24", "n-7-31", "n-7-42", "n-7-56", "n-7-57", "n-7-59", "n-7-61",
"n-7-7", "n-8-10", "n-8-15", "n-8-21", "n-8-30", "n-8-42", "n-8-46",
"n-8-48", "n-8-50", "n-8-54", "n-8-59", "n-8-7", "n-9-13", "n-9-20",
"n-9-22", "n-9-31", "n-9-40", "n-9-41", "n-9-44"], "single": ["default/w0",
"default/w12", "default/w123", "default/w13", "default/w14", "default/w16",
"default/w18", "default/w188", "default/w19", "default/w20", "default/w22",
"default/w23", "default/w25", "default/w26", "default/w27", "default/w30",
"default/w34", "default/w42", "default/w49", "default/w50", "default/w54",
"default/w59", "default/w68", "default/w74", "default/w77", "default/w8",
"default/w81", "default/w9", "default/w90"], "multi": ["default/w2"],
"replaced": ["default/w0", "default/w12", "default/w123", "default/w13",
"default/w14", "default/w16", "default/w18", "default/w188", "default/w19",
"default/w20", "default/w22", "default/w23", "default/w25", "default/w26",
"default/w27", "default/w30", "default/w34", "default/w42", "default/w49",
"default/w50", "default/w54", "default/w59", "default/w68", "default/w74",
"default/w77", "default/w8", "default/w81", "default/w9", "default/w90"],
"evicted": ["default/w2"], "assignments":
"8c76ccea3471a8ae69fd947987da3992c6bdb914670b4744390380eb407b8e81",
"digest":
"322e7fe01d94dc178846cc163a55b2adf18d366bf70a9620c1879e2d6efe9cd6"},
"delayed_tas": {"reserved": 102, "pending_topology": 102, "admitted": 102,
"placed": 102, "digest":
"31fa46fa2a92a4b48c868606ffedc7969d4395a5c65ae210773bdb7becbd18f3"},
"flap_trace": {"workloads": 300, "admitted": 300, "finished": 300,
"preemptions": 0, "cycles": 123, "sim_wall_ms": 4100.0, "tta_ms_by_class":
{"large": 525.0, "medium": 2368.182, "small": 3268.571}, "node_flaps":
[{"atMs": 40.0, "down": true, "nodes": ["n-3-55", "n-9-36", "n-8-5"]},
{"atMs": 90.0, "down": true, "nodes": ["n-2-13", "n-5-62"]}, {"atMs": 400.0,
"down": false, "nodes": ["n-3-55", "n-9-36", "n-8-5", "n-2-13",
"n-5-62"]}]}}
""")
#: phase 20's shapes (tests/torch_dispatch_pins.py holds the same): (a)
#: bench.py's round timeout and sizes (bench.py:1946-1947); (b) per
#: worker (name, cohorts, ClusterQueues per cohort, quota scale, fill:
#: None for the whole generated backlog, else the share of the worker's
#: nominal quota its arrival-ordered pending prefix may reach), the
#: candidate's cpu and the pricing's clock; (c) the flap's seed and size
#: and the controller's reconcile times; (d) the TAS drain store's
#: depth; (e) the trace's flaps (ms, down, count) and seed
ROUND_TIMEOUT = 15.0
BENCH_SIZES = (300, 3000, 1000, 300, 2500, 1500)
FLEET = (("w0", 1, 10, 0.5, None), ("w1", 2, 5, 0.75, None),
         ("w2", 1, 10, 1.0, None), ("w3", 2, 5, 1.25, None),
         ("w4", 1, 10, 1.5, 0.9), ("w5", 2, 5, 1.75, 0.6),
         ("w6", 1, 10, 2.0, 0.75), ("w7", 2, 5, 0.5, None))
FLEET_CPU = 5
FLEET_NOW = 10.0
FLAP_SEED = 36
FLAP_COUNT = 96
FAILURE_TIMES = (200.0, 231.0, 600.0)
DELAYED_WORKLOADS = 1500
TRACE_FLAPS = ((40.0, True, 3), (90.0, True, 2), (400.0, False, 0))
TRACE_SEED = 3


def bench_worker(name: str, quota: int, background_cpu=(),
                 device="cuda"):
    """bench.py's ``worker_env`` (bench.py:1852-1868) on the port."""
    from kueue_oss_tpu_torch.api import types as T
    from kueue_oss_tpu_torch.multikueue import WorkerEnvironment

    env = WorkerEnvironment(name, device=device)
    store = env.store
    store.upsert_resource_flavor(T.ResourceFlavor(name="f0"))
    store.upsert_cluster_queue(T.ClusterQueue(
        name="wcq", preemption=T.PreemptionPolicy(),
        resource_groups=[T.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[T.FlavorQuotas(name="f0", resources=[
                T.ResourceQuota(name="cpu", nominal=quota)])])]))
    store.upsert_local_queue(T.LocalQueue(name="lq", cluster_queue="wcq"))
    for i, cpu in enumerate(background_cpu):
        store.add_workload(T.Workload(
            name=f"bg{i}", queue_name="lq", creation_time=float(i),
            uid=i + 1, podsets=[T.PodSet(count=1, requests={"cpu": cpu})]))
    env.run_cycle(5.0)
    return env


def bench_workers(device="cuda") -> list:
    return [bench_worker("tight-a", 2000, (1500,), device),
            bench_worker("tight-b", 2500, (2000,), device),
            bench_worker("tight-c", 2000, (1600,), device),
            bench_worker("roomy", 8000, (1000,), device)]


class _Hub:
    """bench.py's hub (bench.py:1878-1933) on the port: the MultiKueue
    admission check on its one ClusterQueue, a host scheduler, the
    workload reconciler and the MultiKueue controller."""

    def __init__(self, workers, dispatcher, device="cuda") -> None:
        from kueue_oss_tpu_torch.api import types as T
        from kueue_oss_tpu_torch.controllers import WorkloadReconciler
        from kueue_oss_tpu_torch.core.queue_manager import QueueManager
        from kueue_oss_tpu_torch.core.store import Store
        from kueue_oss_tpu_torch.multikueue import (
            MULTIKUEUE_CONTROLLER_NAME,
            MultiKueueCluster,
            MultiKueueController,
        )
        from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler

        self.T = T
        self.store = Store()
        self.store.upsert_resource_flavor(T.ResourceFlavor(name="f0"))
        self.store.upsert_cluster_queue(T.ClusterQueue(
            name="hubcq", admission_checks=["multikueue"],
            resource_groups=[T.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[T.FlavorQuotas(name="f0", resources=[
                    T.ResourceQuota(name="cpu", nominal=16000)])])]))
        self.store.upsert_local_queue(T.LocalQueue(
            name="lq", cluster_queue="hubcq"))
        self.store.upsert_admission_check(T.AdmissionCheck(
            name="multikueue",
            controller_name=MULTIKUEUE_CONTROLLER_NAME))
        self.scheduler = Scheduler(self.store, QueueManager(self.store),
                                   device=device)
        self.wr = WorkloadReconciler(self.store, self.scheduler)
        self.clusters = [MultiKueueCluster(name=e.name, environment=e)
                         for e in workers]
        self.mk = MultiKueueController(self.store, self.scheduler,
                                       self.clusters, dispatcher=dispatcher)
        self.t = 10.0

    def submit(self, cpu: int) -> None:
        self.t += 1.0
        self.store.add_workload(self.T.Workload(
            name="wl", queue_name="lq", creation_time=self.t, uid=1000,
            podsets=[self.T.PodSet(count=1, requests={"cpu": cpu})]))

    def tick(self) -> None:
        self.t += 1.0
        self.scheduler.schedule(self.t)
        self.mk.reconcile_all(self.t)
        for c in self.clusters:
            if c.active:
                c.environment.run_cycle(self.t)
        self.mk.reconcile_all(self.t)
        self.wr.reconcile_all(self.t)


def _dispatch_once(dispatcher, cpu: int, device="cuda"):
    """bench.py's ``dispatch_once``: (time to admit in simulated s, the
    winner)."""
    hub = _Hub(bench_workers(device), dispatcher, device)
    hub.submit(cpu)
    t_submit = hub.t
    for _ in range(60):
        hub.tick()
        wl = hub.store.workloads["default/wl"]
        st = wl.status.admission_checks.get("multikueue")
        if st is not None and st.state == "Ready":
            return hub.t - t_submit, wl.status.cluster_name
    raise AssertionError(f"dispatch never admitted (cpu={cpu})")


def report_record(report) -> dict:
    """The fields of a DispatchReport that the JAX package pins."""
    return {"best": report.best,
            "scores": [[s.cluster, s.admitted, s.admit_round,
                        s.util_fraction] for s in report.scores],
            "unpriceable": dict(sorted(report.unpriceable.items())),
            "batch_width": report.batch_width,
            "oracle_best": report.oracle_best,
            "oracle_identical": report.oracle_identical}


def fleet_envs(device="cuda", cqs_cut: int = 0) -> dict:
    """Phase 20 (b)'s workers: Kueue's large-scale generator config
    without preemption per FLEET row, quotas scaled, the whole backlog
    (or, with a fill, its arrival-ordered prefix within that share of
    the nominal quota) added pending with uids 1..n in arrival order;
    ``cqs_cut`` > 0 keeps that many ClusterQueues per worker (the tests'
    small size)."""
    from kueue_oss_tpu_torch.multikueue import WorkerEnvironment
    from kueue_oss_tpu_torch.perf import generator as gen

    out = {}
    for name, n_cohorts, cqs, scale, fill in FLEET:
        if cqs_cut:
            n_cohorts, cqs = (1, cqs_cut) if n_cohorts == 1 else (
                2, max(1, cqs_cut // 2))
        cfg = gen.GeneratorConfig.large_scale(preemption=False)
        cfg.n_cohorts, cfg.cqs_per_cohort = n_cohorts, cqs
        cfg.nominal_quota = int(round(cfg.nominal_quota * scale))
        store, schedule = gen.generate(cfg)
        env = WorkerEnvironment(name, store=store, device=device)
        budget = fill * cfg.nominal_quota * n_cohorts * cqs if fill else 0
        cpu = 0
        for i, g in enumerate(schedule):
            if fill is not None:
                cpu += sum(ps.count * ps.requests["cpu"]
                           for ps in g.workload.podsets)
                if cpu > budget:
                    break
            g.workload.uid = i + 1
            store.add_workload(g.workload)
        out[name] = env
    return out


def fleet_candidate_report(envs: dict, device="cuda"):
    """One priced nomination over ``envs`` with the sequential oracle."""
    from kueue_oss_tpu_torch.api import types as T
    from kueue_oss_tpu_torch.sim.dispatch import price_dispatch

    wl = T.Workload(name="cand", queue_name="lq-cq-0-0", uid=99999,
                    creation_time=FLEET_NOW, priority=100,
                    podsets=[T.PodSet(count=1,
                                      requests={"cpu": FLEET_CPU})])
    return price_dispatch(wl, envs, now=FLEET_NOW, check_oracle=True,
                          device=device)


def _assignments_digest(store, keys) -> str:
    import hashlib

    rows = []
    for key in keys:
        adm = store.workloads[key].status.admission
        rows.append([key, None if adm is None else [
            [psa.name, None if psa.topology_assignment is None else
             [list(psa.topology_assignment.levels),
              [[list(d.values), d.count]
               for d in psa.topology_assignment.domains]]]
            for psa in adm.podset_assignments]])
    return hashlib.sha256(json.dumps(
        rows, separators=(",", ":")).encode()).hexdigest()


def node_failure_record(store, sched) -> dict:
    """Phase 20 (c) (tests/torch_dispatch_pins.py ``node_failure_leg``):
    FLAP_COUNT seeded nodes down, the failure controller at
    FAILURE_TIMES with TASDeviceFillCounts on."""
    from kueue_oss_tpu_torch import features
    from kueue_oss_tpu_torch.chaos import NodeFlapInjector
    from kueue_oss_tpu_torch.controllers import NodeFailureController

    nfc = NodeFailureController(store, sched, grace_period_s=30.0,
                                recovery_timeout_s=300.0)
    injector = NodeFlapInjector(store, seed=FLAP_SEED)
    before = {k: _assignments_digest(store, [k])
              for k, w in store.workloads.items() if w.is_quota_reserved}
    down = injector.flap_down(count=FLAP_COUNT)
    hit = {}
    for key in before:
        n = len(nfc._assigned_nodes(store.workloads[key]) & set(down))
        if n:
            hit[key] = n
    features.set_gates({"TASDeviceFillCounts": True})
    try:
        for t in FAILURE_TIMES:
            nfc.reconcile(t)
    finally:
        features.set_gates({"TASDeviceFillCounts": False})
    evicted = sorted(k for k in hit if store.workloads[k].is_evicted)
    replaced = sorted(
        k for k in hit if not store.workloads[k].is_evicted
        and _assignments_digest(store, [k]) != before[k])
    return {"down": sorted(down),
            "single": sorted(k for k, n in hit.items() if n == 1),
            "multi": sorted(k for k, n in hit.items() if n > 1),
            "replaced": replaced, "evicted": evicted,
            "assignments": _assignments_digest(store, replaced),
            "digest": committed_store_digest(store)}


def delayed_tas_store(n_workloads: int = DELAYED_WORKLOADS):
    """The TAS drain store cut to its first ``n_workloads``, with the
    admission check ``prov`` on every ClusterQueue."""
    from kueue_oss_tpu_torch.api import types as T
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import tas_drain_store

    store = tas_drain_store(T, Store, n_workloads=n_workloads)
    store.upsert_admission_check(T.AdmissionCheck(
        name="prov", controller_name="example.com/provisioning"))
    for cq in list(store.cluster_queues.values()):
        cq.admission_checks = ["prov"]
        store.upsert_cluster_queue(cq)
    return store


def delayed_tas_record(store, device="cuda", ticks: int = 6) -> dict:
    """Phase 20 (d) (tests/torch_dispatch_pins.py ``delayed_tas_leg``)."""
    from kueue_oss_tpu_torch import features
    from kueue_oss_tpu_torch.controllers import WorkloadReconciler
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler

    sched = Scheduler(store, QueueManager(store), device=device)
    wr = WorkloadReconciler(store, sched)
    features.set_gates({"TASDeviceFillCounts": True})
    try:
        sched.run_until_quiet(now=100.0, tick=0.001)
        reserved = sorted(k for k, w in store.workloads.items()
                          if w.is_quota_reserved)
        pending_topology = sum(
            1 for k in reserved for psa in
            store.workloads[k].status.admission.podset_assignments
            if psa.delayed_topology_request == "Pending")
        now = 200.0
        for _ in range(ticks):
            for k in reserved:
                for st in store.workloads[k].status.admission_checks.values():
                    st.state = "Ready"
            wr.reconcile_all(now)
            now += 1.0
            sched.schedule(now)
        wr.reconcile_all(now)
    finally:
        features.set_gates({"TASDeviceFillCounts": False})
    admitted = sorted(k for k, w in store.workloads.items()
                      if w.is_admitted)
    return {"reserved": len(reserved), "pending_topology": pending_topology,
            "admitted": len(admitted),
            "placed": sum(1 for k in reserved for psa in
                          store.workloads[k].status.admission
                          .podset_assignments
                          if psa.delayed_topology_request == "Ready"),
            "digest": committed_store_digest(store)}


def flap_trace():
    """Phase 20 (e)'s trace: Kueue's large-scale mix at 2 x 3
    ClusterQueues without preemption (uids 1..n in arrival order), the
    TAS drain store's 640 nodes, and the flap spec."""
    from kueue_oss_tpu_torch.api import types as T
    from kueue_oss_tpu_torch.perf import generator as gen
    from kueue_oss_tpu_torch.scenarios import BLOCK, RACK
    from kueue_oss_tpu_torch.sim import FlapEvent, ScenarioSpec

    cfg = gen.GeneratorConfig.large_scale(preemption=False)
    cfg.n_cohorts, cfg.cqs_per_cohort = 2, 3
    store, schedule = gen.generate(cfg)
    for i, g in enumerate(schedule):
        g.workload.uid = i + 1
    for r in range(10):
        for h in range(64):
            store.upsert_node(T.Node(
                name=f"n-{r}-{h}", labels={BLOCK: "b0", RACK: f"r{r}"},
                allocatable={"cpu": 96}))
    spec = ScenarioSpec(name="flappy", arrival_scale=2.0, seed=TRACE_SEED,
                        node_flaps=[FlapEvent(at_ms=at, down=down, count=n)
                                    for at, down, n in TRACE_FLAPS])
    return store, schedule, spec


def dispatch_phase(smi: str, tas_store, tas_sched,
                   device: str = "cuda") -> tuple:
    """Phase 20: (a) bench.py's fleet under WhatIf and Incremental, (b)
    the 8-worker pricing, (c) node-failure recovery on phase 14's store,
    (d) the delayed TAS path, (e) the flap trace. Returns (report,
    fill_counts launches by leg)."""
    import torch

    from kueue_oss_tpu_torch.multikueue import (
        IncrementalDispatcher,
        WhatIfDispatcher,
    )
    from kueue_oss_tpu_torch.sim import simulate_trace
    from kueue_oss_tpu_torch.solver import cuda_relax, cuda_tas

    def check(name, got, want):
        if got != want:
            raise AssertionError(f"phase 20 {name}: {json.dumps(got)} != "
                                 f"the JAX pin {json.dumps(want)}")

    def no_kernel(name):
        if _launches() or cuda_relax.relax_lp.launches:
            raise AssertionError(f"phase 20 {name} launched a kernel")

    out, fills = {"card": smi}, {}
    relax0 = cuda_relax.relax_lp.launches

    # (a) bench.py's fleet; one warm-up dispatch first, as bench.py does
    _dispatch_once(WhatIfDispatcher(round_timeout_s=ROUND_TIMEOUT,
                                    check_oracle=True, device=device),
                   1000, device)
    _reset_launches()
    t0 = time.monotonic()
    rec = {"whatif": [], "incremental": [],
           "winners": {"whatif": [], "incremental": []}, "reports": [],
           "agree": 0, "scored": 0}
    score_ms, faults = [], []
    for label in ("whatif", "incremental"):
        for cpu in BENCH_SIZES:
            disp = (WhatIfDispatcher(round_timeout_s=ROUND_TIMEOUT,
                                     check_oracle=True, device=device)
                    if label == "whatif" else
                    IncrementalDispatcher(round_timeout_s=ROUND_TIMEOUT))
            tta, winner = _dispatch_once(disp, cpu, device)
            rec[label].append(tta)
            rec["winners"][label].append(winner)
            if label == "whatif":
                score_ms += disp.score_ms
                faults += disp.faults
                rep = disp.last_reports.get("default/wl")
                if rep is not None:
                    rec["scored"] += 1
                    rec["reports"].append(report_record(rep))
                    if rep.best == rep.oracle_best and rep.oracle_identical:
                        rec["agree"] += 1
    torch.cuda.synchronize()
    wall_a = time.monotonic() - t0
    no_kernel("(a)")
    if faults:
        raise AssertionError(f"phase 20 (a): the pricer faulted {faults}")
    check("(a)", rec, DISPATCH_REFERENCE["bench_fleet"])
    out["bench_fleet"] = {
        "wall_s": wall_a, "score_ms_mean": sum(score_ms) / len(score_ms),
        "score_ms": score_ms, "pricings": len(score_ms),
        "whatif_tta_s": rec["whatif"], "incremental_tta_s":
            rec["incremental"], "oracle_agreement": f"{rec['agree']}/"
                                                    f"{rec['scored']}"}
    print("[dispatch (a)] bench.py's fleet matches the JAX pin; "
          + json.dumps(out["bench_fleet"]))

    # (b) 8 workers of the large-scale mix, one nomination
    envs = fleet_envs(device)
    pending = {n: len(e.store.workloads) for n, e in envs.items()}
    _reset_launches()
    _settle()
    t0 = time.monotonic()
    report = fleet_candidate_report(envs, device)
    torch.cuda.synchronize()
    wall_b = time.monotonic() - t0
    no_kernel("(b)")
    check("(b)", report_record(report), DISPATCH_REFERENCE["fleet"])
    if not report.oracle_identical or report.best != report.oracle_best:
        raise AssertionError("phase 20 (b): the batch differs from the "
                             "sequential oracle")
    keys = [s.key()[:3] for s in report.scores]
    if len(set(keys)) < 4 or not report.scores[0].admitted:
        raise AssertionError("phase 20 (b): the pricing shows no choice: "
                             + repr(keys))
    out["fleet"] = {"wall_s": wall_b, "solve_s": report.solve_seconds,
                    "oracle_s": wall_b - report.solve_seconds,
                    "rounds": report.rounds,
                    "host_reads": report.host_reads,
                    "batch_width": report.batch_width,
                    "pending": pending}
    print("[dispatch (b)] 8-worker pricing matches the JAX pin and the "
          "sequential oracle; " + json.dumps(out["fleet"]))

    # (c) node-failure recovery on phase 14's host-only store
    _reset_launches()
    t0 = time.monotonic()
    rec = node_failure_record(tas_store, tas_sched)
    torch.cuda.synchronize()
    wall_c = time.monotonic() - t0
    fills["node_failure"] = cuda_tas.launch_counts["fill_counts"]
    if (fills["node_failure"] == 0 or cuda_tas.leaf_states.launches
            or cuda_tas.tas_place_sequential.launches):
        raise AssertionError(f"phase 20 (c): {fills['node_failure']} "
                             f"fill_counts launches")
    check("(c)", rec, DISPATCH_REFERENCE["node_failure"])
    out["node_failure"] = {"wall_s": wall_c, "down": len(rec["down"]),
                           "replaced": len(rec["replaced"]),
                           "evicted": len(rec["evicted"]),
                           "fill_counts": fills["node_failure"]}
    print("[dispatch (c)] node-failure recovery matches the JAX pin; "
          + json.dumps(out["node_failure"]))

    # (d) the delayed TAS path through the second pass
    store = delayed_tas_store()
    _reset_launches()
    _settle()
    t0 = time.monotonic()
    rec = delayed_tas_record(store, device)
    torch.cuda.synchronize()
    wall_d = time.monotonic() - t0
    fills["delayed_tas"] = cuda_tas.launch_counts["fill_counts"]
    if (fills["delayed_tas"] == 0 or cuda_tas.leaf_states.launches
            or cuda_tas.tas_place_sequential.launches):
        raise AssertionError(f"phase 20 (d): {fills['delayed_tas']} "
                             f"fill_counts launches")
    check("(d)", rec, DISPATCH_REFERENCE["delayed_tas"])
    _quota_checks(store)
    out["delayed_tas"] = {"wall_s": wall_d, **rec,
                          "fill_counts": fills["delayed_tas"]}
    print("[dispatch (d)] the delayed TAS path matches the JAX pin; "
          + json.dumps(out["delayed_tas"]))

    # (e) simulate_trace with node flaps
    store, schedule, spec = flap_trace()
    _reset_launches()
    t0 = time.monotonic()
    res = simulate_trace(store, schedule, spec, device=device)
    wall_e = time.monotonic() - t0
    no_kernel("(e)")
    rec = {k: res[k] for k in ("workloads", "admitted", "finished",
                               "preemptions", "cycles", "sim_wall_ms",
                               "tta_ms_by_class", "node_flaps")}
    check("(e)", rec, DISPATCH_REFERENCE["flap_trace"])
    out["flap_trace"] = {"wall_s": wall_e, "cycles": rec["cycles"],
                         "flaps": len(rec["node_flaps"])}
    print("[dispatch (e)] the flap trace matches the JAX pin; "
          + json.dumps(out["flap_trace"]))
    if cuda_relax.relax_lp.launches != relax0:
        raise AssertionError("phase 20 launched relax_lp")
    return out, fills


# -- phase 21: the solver sidecar -------------------------------------------

#: phase 21 (c): bench.py's chaos shape (bench.py:637-664), the churn
#: rounds that follow the storm, and the JAX package's record
#: (``JAX_PLATFORMS=cpu python tests/torch_sidecar_pins.py``)
CHAOS_CQS = 8
CHAOS_QUOTA = 32
CHAOS_WORKLOADS = 1024
CHAOS_SEED = 42
CHAOS_CHURN = 6
CHAOS_FINISH = 16
CHAOS_REFERENCE = {
    "backend_errors": 1, "cycles": [34, 4, 1, 1, 1, 1, 1],
    "digest": "548474da5cf5a50e646afecabcecabe108ac16b47720b8156c49210d"
              "4fef24c7",
    "faults_by_kind": {"corrupt_plan": 1, "crash": 2, "garble": 2,
                       "ok": 5},
    "faults_injected": 5, "frames": {"sync": 6},
    "held": [256, 256, 256, 256, 256, 256, 256], "plans_rejected": 1}
#: phase 21 (d): the breaker drive's store (4 ClusterQueues of 8 cpu, 64
#: one-cpu workloads), the holders each churn round finishes, and the
#: breaker (two failures trip it; its cooldown runs on a fake clock)
BREAKER_CQS = 4
BREAKER_QUOTA = 8
BREAKER_WORKLOADS = 64
BREAKER_FINISH = 4
BREAKER_THRESHOLD = 2
BREAKER_COOLDOWN_S = 30.0


def start_sidecar(path: str, device: str = "cuda"):
    """A sidecar process (``python -m kueue_oss_tpu_torch.solver.service``)
    serving ``path`` on ``device``; started with ``subprocess``, never a
    fork of this process, which has long touched CUDA."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "kueue_oss_tpu_torch.solver.service", path,
         "--device", device], cwd=root, env=env, stdout=subprocess.PIPE,
        text=True)


def stop_sidecar(proc, timeout: float = 60.0) -> dict:
    """SIGTERM the sidecar and return the JSON line it prints on exit:
    frames served by kind, resyncs, evictions and its kernel launches."""
    proc.terminate()
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"the sidecar exited {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1])


def _await_sidecar(path: str, proc) -> float:
    from kueue_oss_tpu_torch.solver.service import wait_for_server

    return wait_for_server(path, timeout_s=180.0,
                           alive=lambda: proc.poll() is None)


def chaos_store(n_cqs: int = CHAOS_CQS, quota: int = CHAOS_QUOTA,
                n_wl: int = CHAOS_WORKLOADS):
    """bench.py's chaos store (the copy of tests/torch_sidecar_pins.py's,
    held to it by the tests)."""
    from kueue_oss_tpu_torch.api import types as T
    from kueue_oss_tpu_torch.core.store import Store

    store = Store()
    store.upsert_resource_flavor(T.ResourceFlavor(name="f"))
    for i in range(n_cqs):
        store.upsert_cluster_queue(T.ClusterQueue(
            name=f"cq{i}", resource_groups=[T.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[T.FlavorQuotas(name="f", resources=[
                    T.ResourceQuota(name="cpu", nominal=quota)])])]))
        store.upsert_local_queue(T.LocalQueue(
            name=f"lq{i}", cluster_queue=f"cq{i}"))
    for i in range(n_wl):
        store.add_workload(T.Workload(
            name=f"w{i}", queue_name=f"lq{i % n_cqs}", uid=i + 1,
            creation_time=float(i),
            podsets=[T.PodSet(name="main", count=1,
                              requests={"cpu": 1})]))
    return store


def _held(store) -> int:
    return sum(1 for w in store.workloads.values()
               if w.is_quota_reserved and not w.is_finished)


def _nominal_checks(store) -> None:
    """No standalone ClusterQueue of phase 21 (c) and (d) above its
    nominal cpu over the workloads that hold quota now."""
    used: dict[str, int] = {}
    for wl in store.workloads.values():
        if wl.is_quota_reserved and not wl.is_finished:
            adm = wl.status.admission
            used[adm.cluster_queue] = used.get(adm.cluster_queue, 0) + sum(
                psa.resource_usage.get("cpu", 0)
                for psa in adm.podset_assignments)
    for name, spec in store.cluster_queues.items():
        nominal = spec.resource_groups[0].flavors[0].resources[0].nominal
        if used.get(name, 0) > nominal:
            raise AssertionError(f"ClusterQueue {name} over its nominal: "
                                 f"{used[name]}")


def chaos_record(device: str = "cuda"):
    """Phase 21 (c): bench.py's chaos scenario and its churn rounds
    through a ChaosSolverServer on ``device`` (the copy of
    tests/torch_sidecar_pins.py's ``chaos_record``, held to it by the
    tests). Returns (record, store, engine)."""
    import os
    import tempfile

    from kueue_oss_tpu_torch.chaos import (
        CORRUPT_PLAN,
        CRASH,
        GARBLE,
        OK,
        TRUNCATE,
        ChaosSolverServer,
        FaultInjector,
    )
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_oss_tpu_torch.solver.engine import SolverEngine
    from kueue_oss_tpu_torch.solver.service import SolverClient

    store = chaos_store()
    queues = QueueManager(store)
    path = os.path.join(tempfile.mkdtemp(), "solver.sock")
    injector = FaultInjector(
        schedule=[CRASH, GARBLE, CORRUPT_PLAN],
        weights={CRASH: 2, GARBLE: 1, TRUNCATE: 1, CORRUPT_PLAN: 1, OK: 3},
        seed=CHAOS_SEED)
    srv = ChaosSolverServer(path, injector, device=device)
    srv.serve_in_background()
    client = SolverClient(path, timeout_s=30.0, max_retries=1,
                          backoff_base_s=0.01)
    sched = Scheduler(store, queues, solver_min_backlog=64, device=device)
    engine = relax_off(SolverEngine(store, queues, device=device,
                                    scheduler=sched, remote=client))
    sched.solver = engine
    try:
        cycles = [sched.run_until_quiet(now=0.0, tick=1.0)]
        seats = [_held(store)]
        for r in range(CHAOS_CHURN):
            holders = sorted(k for k, w in store.workloads.items()
                             if w.is_quota_reserved and not w.is_finished)
            for key in holders[:CHAOS_FINISH]:
                sched.finish_workload(key, now=100.0 + r)
            sched._drain_cost_ema = sched._host_s_per_adm = None
            sched._solver_drained_once = False
            cycles.append(sched.run_until_quiet(now=100.0 + r, tick=1.0))
            seats.append(_held(store))
    finally:
        srv.shutdown()
        srv.server_close()
    rec = {"held": seats, "cycles": cycles,
           "faults_by_kind": dict(sorted(injector.injected.items())),
           "faults_injected": injector.faults_injected(),
           "plans_rejected": engine.remote_counts[
               "solver_plan_rejected_total"],
           "backend_errors": engine.remote_counts["solver_fallback_total"][
               "backend_error"],
           "frames": dict(sorted(client.frames_by_kind.items())),
           "digest": committed_store_digest(store)}
    return rec, store, engine


def breaker_drive(path: str, proc, device: str = "cuda",
                  while_restarting=None) -> dict:
    """Phase 21 (d): the sidecar drive of .claude/skills/verify/SKILL.md
    on the port. A flood through ``Scheduler(solver="auto",
    solver_config=...)`` routed to the sidecar ``proc`` at ``path``, the
    cost gates pinned; the sidecar SIGKILLed; churn rounds (finish
    ``BREAKER_FINISH`` holders, run until quiet) refill every seat on
    the host while the breaker trips open, then refuses drains with no
    socket attempt; a restarted sidecar and the cooldown (a fake clock)
    close it with exactly one probe. ``while_restarting`` (when given)
    runs while the restarted sidecar boots. The control plane's hand
    kernel launches are set to 0 before the flood and must stay 0 after
    every round, and the restarted sidecar must report 0 launches on
    exit. The SIGKILLed sidecar cannot report its launches: its lean and
    FULL solves run the same code as the restarted one's, which calls no
    hand kernel. Returns the report."""
    from kueue_oss_tpu_torch.config import SolverBackendConfig
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_oss_tpu_torch.solver.resilience import CLOSED, OPEN

    store = chaos_store(BREAKER_CQS, BREAKER_QUOTA, BREAKER_WORKLOADS)
    seats = BREAKER_CQS * BREAKER_QUOTA
    cfg = SolverBackendConfig(
        socket_path=path, timeout_seconds=10.0, max_retries=0,
        retry_backoff_base_seconds=0.01,
        breaker_failure_threshold=BREAKER_THRESHOLD,
        breaker_cooldown_seconds=BREAKER_COOLDOWN_S, relax_enabled=False)
    sched = Scheduler(store, QueueManager(store), solver="auto",
                      solver_min_backlog=8, solver_config=cfg,
                      device=device)
    engine = sched._solver_engine()
    client, health = engine.remote, engine.health
    clock = [0.0]
    health.clock = lambda: clock[0]
    log = []

    def round_(label: str, finish: bool, now: float) -> dict:
        if finish:
            holders = sorted(k for k, w in store.workloads.items()
                             if w.is_quota_reserved and not w.is_finished)
            for key in holders[:BREAKER_FINISH]:
                sched.finish_workload(key, now=now)
        sched._drain_cost_ema = sched._host_s_per_adm = None
        sched._solver_drained_once = False
        attempts0, counts0 = client.attempts, dict(sched.solver_counts)
        t0 = time.monotonic()
        sched.run_until_quiet(now=now, tick=0.001)
        row = {"label": label, "wall_s": time.monotonic() - t0,
               "held": _held(store), "state": health.state,
               "attempts": client.attempts - attempts0,
               **{k: sched.solver_counts[k] - counts0[k]
                  for k in ("drains", "unavailable")}}
        if row["held"] != seats:
            raise AssertionError(f"phase 21 (d) {label}: {row['held']} of "
                                 f"{seats} seats held")
        if _launches():
            raise AssertionError(f"phase 21 (d) {label}: the control plane "
                                 f"launched {_launches()} TAS kernels")
        _nominal_checks(store)
        log.append(row)
        return row

    _await_sidecar(path, proc)
    _reset_launches()
    first = round_("flood", False, 0.0)
    if first["drains"] != 1 or first["state"] != CLOSED:
        raise AssertionError(f"phase 21 (d) flood: {first}")
    proc.kill()  # SIGKILL: no goodbye, the socket file stays behind
    proc.wait()
    for i in range(BREAKER_THRESHOLD):
        row = round_(f"dead{i + 1}", True, 10.0 + i)
        if row["unavailable"] != 1 or row["attempts"] != 1:
            raise AssertionError(f"phase 21 (d) dead sidecar: {row}")
    if health.state != OPEN or health.trips != 1:
        raise AssertionError(f"phase 21 (d): breaker {health.state}, "
                             f"{health.trips} trips after "
                             f"{BREAKER_THRESHOLD} failures")
    restarted = start_sidecar(path, device)
    try:
        row = round_("open", True, 20.0)
        if (row["attempts"] or row["unavailable"] != 1
                or health.state != OPEN):
            raise AssertionError(f"phase 21 (d) open breaker: {row}")
        if while_restarting is not None:
            while_restarting()
        _await_sidecar(path, restarted)
        clock[0] += BREAKER_COOLDOWN_S
        row = round_("probe", True, 30.0)
        if (row["attempts"] != 1 or row["drains"] != 1
                or health.state != CLOSED or health.trips != 1):
            raise AssertionError(f"phase 21 (d) probe: {row}")
        row = round_("healed", True, 40.0)
        if row["drains"] != 1 or health.state != CLOSED:
            raise AssertionError(f"phase 21 (d) after the probe: {row}")
    finally:
        served = stop_sidecar(restarted)
    if any(served["launches"].values()):
        raise AssertionError(f"phase 21 (d): the restarted sidecar launched "
                             f"a hand kernel: {served}")
    return {"rounds": log, "frames": dict(client.frames_by_kind),
            "failures": dict(client.failures), "trips": health.trips,
            "restarted_sidecar": served}


def _check_remote_storm_drain(phase: str, i: int, label: str, now: float,
                              store, result, before, engine) -> tuple:
    """Hold drain ``i`` of phase 10's storm and churn, solved through a
    sidecar, to its pin (``STORM_CHURN_REFERENCE``): the plan, the
    reasons, the session frame and the kind sent on the wire. Returns
    (the drain's record, the frame kind sent)."""
    ref = STORM_CHURN_REFERENCE[i]
    if (label, now) != (ref["label"], ref["now"]):
        raise AssertionError(f"{phase} drain {i}: {label}")
    want = {k: ref[k] for k in ("admitted", "evicted", "rounds", "held",
                                "digest")}
    got = _check_storm_wave(store, result, before, want)
    reasons = dict(collections.Counter(
        store.workloads[k].status.conditions["Preempted"].reason
        for k in result.evicted_keys))
    kind = _frame_summary(result)["frame"]
    sent = "delta" if kind == "delta" else "sync"
    client = engine.remote
    if (reasons != ref["reasons"] or kind != ref["frame"]
            or client.last_frame[0] != sent
            or engine.last_drain_arm != "remote"):
        raise AssertionError(
            f"{phase} {label}: reasons {reasons}, session frame {kind} "
            f"sent as {client.last_frame}, arm {engine.last_drain_arm}; "
            f"reference {ref['reasons']}, {ref['frame']}")
    return got, sent


def sidecar_phase(smi: str, churn_walls=None, device: str = "cuda",
                  sidecar=None) -> tuple:
    """Phase 21: (a) phase 10's storm and churn through a sidecar
    process, (b) the scheduler's TAS entry point through it, (c) the
    chaos storm (while (d)'s restarted sidecar boots), (d) the breaker.
    ``churn_walls`` maps phase 10's drain labels to their in-process
    walls (None when phase 10 did not run); ``sidecar`` is (path,
    process) of an (a) sidecar started earlier, so that it booted while
    earlier phases ran. Returns (report, tas_place_sequential launches
    of the control plane)."""
    import os
    import statistics
    import tempfile

    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.config import SolverBackendConfig
    from kueue_oss_tpu_torch.core.eviction import finish_workload
    from kueue_oss_tpu_torch.core.queue_manager import QueueManager
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.scenarios import (
        baseline_preempt_store,
        storm_churn_drains,
        tas_drain_store,
    )
    from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_oss_tpu_torch.solver import cuda_relax, cuda_tas
    from kueue_oss_tpu_torch.solver.engine import SolverEngine
    from kueue_oss_tpu_torch.solver.service import SolverClient

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    relax0 = cuda_relax.relax_lp.launches
    tmp = tempfile.mkdtemp()
    path_d = os.path.join(tmp, "d.sock")
    if sidecar is None:
        path_a = os.path.join(tmp, "a.sock")
        sidecar_a = start_sidecar(path_a, device)
    else:
        path_a, sidecar_a = sidecar
    sidecar_d = None
    out = {}
    try:
        # (a) phase 10's sequence through the sidecar, full size
        store, wave1, wave2 = baseline_preempt_store(types, Store)
        queues = QueueManager(store)
        client = SolverClient(path_a)
        engine = relax_off(SolverEngine(store, queues, device=device,
                                        remote=client))
        steps = storm_churn_drains(
            types, store, wave1, wave2,
            lambda key, now: finish_workload(store, queues, key, now))
        out["sidecar_boot_s"] = _await_sidecar(path_a, sidecar_a)
        drains, wire = [], []
        for i, (label, now) in enumerate(steps):
            before = _reserved_state(store)
            _reset_launches()
            _settle()
            t0 = time.monotonic()
            result = engine.drain(now=now)
            sync()
            wall = time.monotonic() - t0
            got, sent = _check_remote_storm_drain(
                "phase 21 (a)", i, label, now, store, result, before,
                engine)
            if _launches():
                raise AssertionError(f"phase 21 (a) {label}: "
                                     f"{_launches()} TAS launches")
            wire.append(client.last_frame)
            drains.append({
                "label": label, "wall_s": wall, "frame": sent,
                "frame_bytes": client.last_frame[1],
                "in_process_wall_s": (churn_walls or {}).get(label),
                **{f"{k}_s": v for k, v in result.phases.items()}})
            print(f"[sidecar (a) {label}] plan matches the reference "
                  f"({got['admitted']} admitted, {got['evicted']} evicted, "
                  f"{got['rounds']} rounds); " + json.dumps(drains[-1]))
        n_delta = sum(1 for kind, _ in wire if kind == "delta")
        if (client.frames_by_kind != {"sync": len(wire) - n_delta,
                                      "delta": n_delta}
                or client.resyncs or client.failures or n_delta == 0
                or wire[0][0] != "sync"):
            raise AssertionError(
                f"phase 21 (a) wire: frames {client.frames_by_kind}, "
                f"resyncs {client.resyncs}, failures {client.failures}")
        delta_bytes = [n for kind, n in wire if kind == "delta"]
        out["storm"] = {
            "drains": drains, "bytes_by_kind": dict(client.bytes_by_kind),
            "frames_by_kind": dict(client.frames_by_kind),
            "sync_frame_bytes": wire[0][1],
            "median_delta_frame_bytes": statistics.median(delta_bytes)}
        print("[sidecar (a)] the storm and its churn through the sidecar "
              "match phase 10's pins; " + json.dumps(
                  {k: v for k, v in out["storm"].items() if k != "drains"}))
        del store, queues, engine, steps

        # (b) the system's entry point, routed by its solver_config
        sidecar_d = start_sidecar(path_d, device)  # boots meanwhile
        tstore = tas_drain_store(types, Store,
                                 n_workloads=STEPWISE_WORKLOADS)
        cfg = SolverBackendConfig(socket_path=path_a, relax_enabled=False)
        sched = Scheduler(tstore, QueueManager(tstore), solver="auto",
                          solver_config=cfg, device=device)
        cuda_tas.tas_place_sequential.steps = 0
        rec, wall, _, oracle, _ = _run_quiet(tstore, sched, [], 0.0)
        tas_launches = cuda_tas.tas_place_sequential.launches
        rec["parked"] = sum(len(q.inadmissible)
                            for q in sched.queues.queues.values())
        want = SCHEDULER_REFERENCE["tas"]
        eng = sched._solver_engine()
        c = sched.solver_counts
        if rec != want:
            raise AssertionError(f"phase 21 (b): {rec} != reference {want}")
        # a CPU rehearsal places through the plain placer: no launch
        if (tas_launches != (0 if device == "cpu" else 1)
                or cuda_tas.leaf_states.launches
                or cuda_tas.launch_counts["fill_counts"]
                or c["unavailable"] or c["unsupported"]
                or eng.last_drain_arm != "remote"
                or eng.remote.socket_path != path_a
                or oracle["rejections"] or oracle["python_calls"]):
            raise AssertionError(
                f"phase 21 (b): {tas_launches} tas_place_sequential "
                f"launches, counts {c}, arm {eng.last_drain_arm}, oracle "
                f"{oracle}")
        _quota_checks(tstore)
        out["scheduler_tas"] = {
            "wall_s": wall, "cycles": rec["cycles"],
            "steps": cuda_tas.tas_place_sequential.steps,
            "frames_by_kind": dict(eng.remote.frames_by_kind),
            "drain": {f"{k}_s": v for k, v in sched.last_drain.phases.items()}}
        print("[sidecar (b)] Scheduler(solver=\"auto\") through the sidecar "
              "matches phase 12's record; 1 tas_place_sequential launch in "
              "the control plane, 0 fallbacks; "
              + json.dumps(out["scheduler_tas"]))
        del tstore, sched, eng
        out["sidecar_a"] = stop_sidecar(sidecar_a)
        sidecar_a = None
        if any(out["sidecar_a"]["launches"].values()):
            raise AssertionError(f"phase 21: the sidecar launched a hand "
                                 f"kernel: {out['sidecar_a']}")

        def chaos():
            # (c) the chaos storm on a ChaosSolverServer on the card
            _reset_launches()
            t0 = time.monotonic()
            rec, cstore, ceng = chaos_record(device)
            sync()
            wall = time.monotonic() - t0
            if rec != CHAOS_REFERENCE:
                raise AssertionError(
                    f"phase 21 (c): {json.dumps(rec)} != the JAX pin "
                    f"{json.dumps(CHAOS_REFERENCE)}")
            _nominal_checks(cstore)
            if _launches():
                raise AssertionError("phase 21 (c) launched a TAS kernel")
            out["chaos"] = {"wall_s": wall, "faults": rec["faults_by_kind"],
                            "plans_rejected": rec["plans_rejected"],
                            "remote_counts": ceng.remote_counts,
                            "client_failures": dict(ceng.remote.failures),
                            "breaker": ceng.health.state}
            print("[sidecar (c)] the chaos storm matches the JAX pin (every "
                  "seat held, no corrupt plan committed); "
                  + json.dumps(out["chaos"]))

        # (d) the breaker: SIGKILL, host refill, open, one probe; (c)
        # runs while the restarted sidecar boots
        t0 = time.monotonic()
        out["breaker"] = breaker_drive(path_d, sidecar_d, device,
                                       while_restarting=chaos)
        out["breaker"]["wall_s"] = (time.monotonic() - t0
                                    - out["chaos"]["wall_s"])
        sidecar_d = None
        print("[sidecar (d)] the breaker tripped on the killed sidecar, "
              "refused drains with no socket attempt, and one probe "
              "closed it; " + json.dumps(out["breaker"]))
    finally:
        for proc in (sidecar_a, sidecar_d):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    if cuda_relax.relax_lp.launches != relax0:
        raise AssertionError("phase 21 launched relax_lp")
    return out, tas_launches


#: phase 22 (a): bench.py's federation phase 1 (bench.py:1674-1848), not
#: cut: 4 tenants x 2 control planes at weights 2:2:1:1 on one farm, a
#: 2 ms quantum, 16 resident sessions, members padded to 64, 24
#: workloads each, 5 s of contended churn (tests/torch_farm_pins.py
#: holds the same constants)
FED_WEIGHTS = {"cp-a": 2.0, "cp-b": 2.0, "cp-c": 1.0, "cp-d": 1.0}
FED_PLANES = 2
FED_QUANTUM_S = 0.002
FED_MAX_SESSIONS = 16
FED_PAD_TO = 64
FED_WARM = 24
FED_SECS = 5.0
#: phase 22 (b): the real-size fleet's tenants and weights (two storm
#: control planes at 2:1, the TAS one at 1)
FLEET_WEIGHTS = {"storm-a": 2.0, "storm-b": 1.0, "tas": 1.0}


def fed_seed_cluster(store, n_cqs: int = 4, quota: int = 8) -> None:
    """bench.py's federation cluster (tests/torch_farm_pins.py's copy):
    4 ClusterQueues of 8 cpu."""
    from kueue_oss_tpu_torch.api import types

    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    for i in range(n_cqs):
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{i}", preemption=types.PreemptionPolicy(),
            resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[types.FlavorQuotas(name="f", resources=[
                    types.ResourceQuota(name="cpu", nominal=quota)])])]))
        store.upsert_local_queue(types.LocalQueue(
            name=f"lq{i}", cluster_queue=f"cq{i}"))


def fed_wl(i: int, cpu: int = 1):
    from kueue_oss_tpu_torch.api import types

    return types.Workload(
        name=f"w{i}", queue_name=f"lq{i % 4}", uid=i + 1,
        creation_time=float(i),
        podsets=[types.PodSet(name="main", count=1,
                              requests={"cpu": cpu})])


def fed_churn(member, cycles: int, uid0: int, t0: int,
              waits=None) -> int:
    """bench.py's churn: per cycle finish two, submit two, drain;
    ``waits`` collects the farm's grant wait echoed by each drain."""
    uid = uid0
    for cyc in range(t0, t0 + cycles):
        admitted = sorted(
            k for k, w in member.store.workloads.items()
            if w.is_quota_reserved and not w.is_finished)
        for k in admitted[:2]:
            member.scheduler.finish_workload(k, now=float(cyc))
        for _ in range(2):
            member.store.add_workload(fed_wl(uid))
            uid += 1
        member.drain(now=float(cyc))
        if waits is not None and member.engine.remote is not None:
            waits.append(member.engine.remote.last_grant_wait_ms)
    return uid


def _farm_server(weights: dict, device: str):
    """A SolverServer on ``device`` with a FarmScheduler loaded from a
    Configuration document (load, validate, from_config, attach_farm)."""
    import os
    import tempfile

    from kueue_oss_tpu_torch import config
    from kueue_oss_tpu_torch.federation import FarmScheduler, attach_farm
    from kueue_oss_tpu_torch.solver.service import SolverServer

    cfg = config.load({"federation": {"tenantWeights": dict(weights),
                                      "quantum": FED_QUANTUM_S}})
    errs = config.validate(cfg)
    if errs:
        raise AssertionError(f"phase 22: the farm's Configuration: {errs}")
    path = os.path.join(tempfile.mkdtemp(), "farm.sock")
    srv = SolverServer(path, device=device, max_sessions=FED_MAX_SESSIONS)
    farm = attach_farm(srv, FarmScheduler.from_config(cfg.federation))
    srv.serve_in_background()
    return path, srv, farm


def _run_threads(targets: dict) -> dict:
    """Run each ``name: fn`` in a thread started together; returns the
    seconds each took and raises the first exception of any."""
    import threading

    errors, walls = {}, {}
    barrier = threading.Barrier(len(targets))

    def body(name, fn):
        try:
            barrier.wait()
            t0 = time.monotonic()
            fn()
            walls[name] = time.monotonic() - t0
        except BaseException as e:  # re-raised on the main thread
            errors[name] = e

    threads = [threading.Thread(target=body, args=(n, fn), daemon=True)
               for n, fn in targets.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    alive = [th.name for th in threads if th.is_alive()]
    if alive:
        raise AssertionError(f"phase 22: threads still running: {alive}")
    for name, e in errors.items():
        raise AssertionError(f"phase 22: {name} failed: {e!r}") from e
    return walls


def _session_sums(srv) -> dict:
    from kueue_oss_tpu_torch.solver.delta import state_checksum

    with srv._sessions_lock:
        return {k: (s, state_checksum(s.kwargs, s.meta))
                for k, s in srv.sessions.items()}


def farm_contention(smi: str, device: str = "cuda",
                    secs: float = FED_SECS) -> dict:
    """Phase 22 (a): bench.py's federation phase 1 on the card. Returns
    the report."""
    import statistics

    import torch

    from kueue_oss_tpu_torch.chaos import ClusterLossInjector
    from kueue_oss_tpu_torch.federation import build_member, plan_fingerprint
    from kueue_oss_tpu_torch.solver import cuda_relax
    from kueue_oss_tpu_torch.solver.delta import state_checksum
    from kueue_oss_tpu_torch.solver.resilience import SolverUnavailable

    t_phase = time.monotonic()
    # every launch from here to the end of (a) is counted: the members,
    # the farm's server, the dedicated twins, the heal and the throttle
    _reset_launches()
    relax0 = cuda_relax.relax_lp.launches
    path, srv, farm = _farm_server(FED_WEIGHTS, device)
    out = {}
    try:
        names = [f"{t}/{j}" for t in FED_WEIGHTS for j in range(FED_PLANES)]
        offsets = {n: 10000 * i for i, n in enumerate(names)}
        members = {n: build_member(n.split("/")[0], socket_path=path,
                                   seed=fed_seed_cluster, pad_to=FED_PAD_TO,
                                   device=device) for n in names}
        for m in members.values():
            relax_off(m.engine)
        # warm one after another (the SYNC, the first solves) so that no
        # set-up lands on one tenant's bill
        uids = {}
        t0 = time.monotonic()
        for name, m in members.items():
            for i in range(FED_WARM):
                m.store.add_workload(fed_wl(i + offsets[name]))
            m.drain(now=0.0)
            uids[name] = fed_churn(m, 2, offsets[name] + 100, t0=1)
        out["warm_s"] = time.monotonic() - t0
        base_wall = dict(farm.wall_by_tenant)
        base_served = dict(farm.served)
        base_throttled = dict(farm.throttled)
        cycles_run = {}
        waits = {n: [] for n in names}

        def contend(name):
            m = members[name]
            deadline = time.monotonic() + secs
            cyc = 3
            while time.monotonic() < deadline:
                uids[name] = fed_churn(m, 1, uids[name], t0=cyc,
                                       waits=waits[name])
                cyc += 1
            cycles_run[name] = cyc - 3

        t0 = time.monotonic()
        _run_threads({n: (lambda n=n: contend(n)) for n in names})
        if device != "cpu":
            torch.cuda.synchronize()
        out["contended_s"] = time.monotonic() - t0
        shares = {t: farm.wall_by_tenant.get(t, 0.0) - base_wall.get(t, 0.0)
                  for t in FED_WEIGHTS}
        served = {t: farm.served.get(t, 0) - base_served.get(t, 0)
                  for t in FED_WEIGHTS}
        norm = {t: shares[t] / FED_WEIGHTS[t] for t in FED_WEIGHTS}
        tenant_waits = {t: [w for n in names if n.startswith(t + "/")
                            for w in waits[n]] for t in FED_WEIGHTS}
        out.update(
            solves=sum(served.values()), served=served, wall_shares=shares,
            # printed, not gated: DRR fairness is held on the CPU
            spread=(max(norm.values()) / min(norm.values())
                    if min(norm.values()) > 0 else None),
            throttled={t: farm.throttled.get(t, 0)
                       - base_throttled.get(t, 0) for t in FED_WEIGHTS},
            cycles=cycles_run,
            grant_wait_ms={t: {"mean": statistics.fmean(w), "max": max(w)}
                           for t, w in tenant_waits.items() if w})
        # zero cross-tenant state: each resident session's checksum is
        # one of its own tenant's host sessions and no other tenant's
        host = {}
        for name, m in members.items():
            kwargs, meta = next(iter(m.engine._delta_sessions.values()))._last
            host[name] = state_checksum(kwargs, meta)
        side = _session_sums(srv)
        bad = [k for k, (_, chk) in side.items()
               if chk not in {v for n, v in host.items()
                              if n.split("/")[0] == k[0]}
               or chk in {v for n, v in host.items()
                          if n.split("/")[0] != k[0]}]
        if bad or len(side) != len(members):
            raise AssertionError(f"phase 22 (a): cross-tenant state in "
                                 f"{bad}, {len(side)} sessions")
        # every member's plan equals its dedicated twin's on the card
        t0 = time.monotonic()
        for name, m in members.items():
            twin = build_member(f"{name}-twin", seed=fed_seed_cluster,
                                pad_to=FED_PAD_TO, device=device)
            relax_off(twin.engine)
            twin.engine.use_sessions = False
            for i in range(FED_WARM):
                twin.store.add_workload(fed_wl(i + offsets[name]))
            twin.drain(now=0.0)
            uid = fed_churn(twin, 2, offsets[name] + 100, t0=1)
            fed_churn(twin, cycles_run[name], uid, t0=3)
            if (plan_fingerprint(twin.store, twin.queues)
                    != plan_fingerprint(m.store, m.queues)):
                raise AssertionError(f"phase 22 (a): {name}'s plan differs "
                                     f"from its dedicated twin's")
        out["twins_s"] = time.monotonic() - t0
        # evict cp-c's sessions: each of its control planes heals with
        # one counted resync, its neighbours' sessions are untouched
        injector = ClusterLossInjector(controller=None, farm_server=srv)
        neighbours = {k: v for k, v in side.items() if k[0] != "cp-c"}
        evicted = injector.evict_farm_tenant("cp-c")
        resyncs0 = dict(srv.resyncs)
        for name in names:
            if name.startswith("cp-c/"):
                uids[name] = fed_churn(members[name], 1, uids[name],
                                       t0=1000)
                if members[name].engine.remote.resyncs != {
                        "session_missing": 1}:
                    raise AssertionError(
                        f"phase 22 (a): {name} resyncs "
                        f"{members[name].engine.remote.resyncs}")
        after = _session_sums(srv)
        healed = sum(1 for k in after if k[0] == "cp-c")
        if (evicted != FED_PLANES or healed != FED_PLANES
                or srv.resyncs.get("session_missing", 0)
                - resyncs0.get("session_missing", 0) != FED_PLANES
                or any(after.get(k, (None,))[0] is not s
                       or after[k][1] != chk
                       for k, (s, chk) in neighbours.items())):
            raise AssertionError(
                f"phase 22 (a): eviction of cp-c: {evicted} evicted, "
                f"{healed} healed, resyncs {srv.resyncs}")
        # throttle cp-d: its next drain degrades to host cycles without
        # spending the solve slot
        m = members["cp-d/0"]
        served_d, throttled_d = farm.served["cp-d"], farm.throttled.get(
            "cp-d", 0)
        failures0 = m.engine.health.consecutive_failures
        farm.force_throttle("cp-d")
        admitted = sorted(k for k, w in m.store.workloads.items()
                          if w.is_quota_reserved and not w.is_finished)
        m.scheduler.finish_workload(admitted[0], now=2000.0)
        wl = fed_wl(uids["cp-d/0"])
        m.store.add_workload(wl)
        try:
            m.drain(now=2000.0)
            raise AssertionError("phase 22 (a): a throttled drain ran")
        except SolverUnavailable as e:
            if "backpressure" not in str(e):
                raise
        m.scheduler.run_until_quiet(now=2001.0)
        if (farm.served["cp-d"] != served_d
                or farm.throttled["cp-d"] != throttled_d + 1
                or m.engine.health.consecutive_failures != failures0 + 1
                or not wl.is_quota_reserved):
            raise AssertionError(
                f"phase 22 (a): throttled cp-d: served {farm.served}, "
                f"throttled {farm.throttled}, breaker "
                f"{m.engine.health.consecutive_failures}")
        if _launches() or cuda_relax.relax_lp.launches != relax0:
            raise AssertionError(
                f"phase 22 (a): {_launches()} TAS kernel launches, "
                f"{cuda_relax.relax_lp.launches - relax0} relax_lp; "
                f"expected 0")
        out["evicted_sessions"] = evicted
        out["phase_s"] = time.monotonic() - t_phase
    finally:
        srv.shutdown()
        srv.server_close()
    print(f"[federation (a)] {out['solves']} solves in "
          f"{out['contended_s']:.3f} s of contention; wall shares "
          f"{json.dumps(out['wall_shares'])}, spread of share / weight "
          f"{out['spread']}; throttled {json.dumps(out['throttled'])}; "
          f"grant waits {json.dumps(out['grant_wait_ms'])}; zero "
          f"cross-tenant state, every plan its dedicated twin's, cp-c "
          f"healed with one resync a plane, cp-d degraded to host cycles "
          f"({smi}); " + json.dumps(out))
    return out


def fleet_real(smi: str, device: str = "cuda") -> tuple:
    """Phase 22 (b): a fleet at real size on one farm, tenants in
    threads: two control planes on phase 10's storm and churn (weights
    2:1), one on phase 12's TAS store. Returns (report, the placer's
    launches)."""
    import torch

    from kueue_oss_tpu_torch.api import types
    from kueue_oss_tpu_torch.core.eviction import finish_workload
    from kueue_oss_tpu_torch.core.store import Store
    from kueue_oss_tpu_torch.federation import build_member
    from kueue_oss_tpu_torch.scenarios import (
        baseline_preempt_store,
        storm_churn_drains,
        tas_drain_store,
    )
    from kueue_oss_tpu_torch.solver import cuda_relax, cuda_tas

    t_phase = time.monotonic()
    path, srv, farm = _farm_server(FLEET_WEIGHTS, device)
    out = {}
    try:
        storms, steps = {}, {}
        for name in ("storm-a", "storm-b"):
            store, wave1, wave2 = baseline_preempt_store(types, Store)
            m = storms[name] = build_member(name, socket_path=path,
                                            store=store, device=device)
            relax_off(m.engine)
            steps[name] = storm_churn_drains(
                types, store, wave1, wave2,
                lambda key, now, m=m: finish_workload(m.store, m.queues,
                                                      key, now))
        tas = build_member("tas", socket_path=path, device=device,
                           store=tas_drain_store(
                               types, Store, n_workloads=STEPWISE_WORKLOADS))
        relax_off(tas.engine)
        # the system's entry point over the member's remote engine
        tas.scheduler.solver = tas.engine
        out["build_s"] = time.monotonic() - t_phase
        records = {}

        def storm(name):
            m = storms[name]
            walls = []
            for i, (label, now) in enumerate(steps[name]):
                before = _reserved_state(m.store)
                t0 = time.monotonic()
                result = m.drain(now=now)
                walls.append(time.monotonic() - t0)
                _check_remote_storm_drain(f"phase 22 (b) {name}", i, label,
                                          now, m.store, result, before,
                                          m.engine)
            if len(walls) != len(STORM_CHURN_REFERENCE):
                raise AssertionError(f"phase 22 (b) {name}: {len(walls)} "
                                     f"drains")
            records[name] = {"drain_s": walls,
                             "frames_by_kind":
                                 dict(m.engine.remote.frames_by_kind)}

        def tas_plane():
            sched = tas.scheduler
            counts0 = dict(sched.solver_counts)
            t0 = time.monotonic()
            cycles = sched.run_until_quiet(now=0.0, tick=0.001)
            wall = time.monotonic() - t0
            rec = _scheduler_record(tas.store, sched, cycles, counts0)
            rec["parked"] = sum(len(q.inadmissible)
                                for q in sched.queues.queues.values())
            if rec != SCHEDULER_REFERENCE["tas"]:
                raise AssertionError(f"phase 22 (b) tas: {rec} != "
                                     f"{SCHEDULER_REFERENCE['tas']}")
            if tas.engine.last_drain_arm != "remote":
                raise AssertionError("phase 22 (b) tas: drained locally")
            records["tas"] = {"wall_s": wall, "cycles": cycles}

        _reset_launches()
        cuda_tas.tas_place_sequential.steps = 0
        relax0 = cuda_relax.relax_lp.launches
        _settle()
        t0 = time.monotonic()
        out["thread_s"] = _run_threads({"storm-a": lambda: storm("storm-a"),
                                        "storm-b": lambda: storm("storm-b"),
                                        "tas": tas_plane})
        if device != "cpu":
            torch.cuda.synchronize()
        out["fleet_s"] = time.monotonic() - t0
        place = cuda_tas.tas_place_sequential.launches
        placed = cuda_tas.tas_place_sequential.steps
        leaf = cuda_tas.leaf_states.launches
        fills = cuda_tas.launch_counts["fill_counts"]
        relax = cuda_relax.relax_lp.launches - relax0
        # the placer launches once in the TAS plane's one drain (a CPU
        # rehearsal places through the plain placer: no launch)
        want = 0 if device == "cpu" else 1
        want_steps = 0 if device == "cpu" else STEPWISE_REFERENCE["admitted"]
        if (place != want or placed != want_steps or leaf or fills
                or relax):
            raise AssertionError(
                f"phase 22 (b): {place} tas_place_sequential launches "
                f"({placed} steps), {leaf} leaf_states, {fills} "
                f"fill_counts, {relax} relax_lp; expected {want} "
                f"({want_steps}), 0, 0, 0")
        if farm.throttled or srv.resyncs:
            raise AssertionError(f"phase 22 (b): throttled "
                                 f"{farm.throttled}, resyncs {srv.resyncs}")
        _quota_checks(tas.store)
        for m in storms.values():
            _quota_checks(m.store)
        out.update(records=records, served=dict(farm.served),
                   wall_by_tenant=dict(farm.wall_by_tenant),
                   tas_place_sequential=place, steps=placed,
                   grant_wait_ms={n: m.engine.remote.last_grant_wait_ms
                                  for n, m in {**storms,
                                               "tas": tas}.items()})
        out["phase_s"] = time.monotonic() - t_phase
    finally:
        srv.shutdown()
        srv.server_close()
    print(f"[federation (b)] two storm planes (2:1) and the TAS plane on "
          f"one farm match phases 10 and 12's pins; {place} "
          f"tas_place_sequential launch ({placed} steps), 0 leaf_states, "
          f"fill_counts and relax_lp ({smi}); " + json.dumps(out))
    return out, place


def federation_phase(smi: str, device: str = "cuda") -> tuple:
    """Phase 22: the solver farm on the card, (a) bench.py's federation
    phase 1 and (b) a fleet at real size. Returns (report, the placer's
    launches)."""
    t0 = time.monotonic()
    contention = farm_contention(smi, device)
    fleet, place = fleet_real(smi, device)
    return {"federation": contention, "fleet_real": fleet,
            "phase_s": time.monotonic() - t0}, place


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs only on a CUDA device", file=sys.stderr)
        return 1

    # each phase's seconds of wall clock, printed before the timings
    marks = [("start", time.monotonic())]

    def mark(phase: str) -> None:
        marks.append((phase, time.monotonic()))

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

    if sys.argv[1:] == ["--phase", "21"]:
        # phase 21 alone: the sidecar (no phase 10 walls to compare)
        sidecar, sidecar_place = sidecar_phase(smi)
        print("[timings] " + json.dumps({"sidecar": sidecar,
                                         "tas_place_sequential":
                                             sidecar_place}))
        print(smi)
        return 0

    if sys.argv[1:] == ["--phase", "22"]:
        # phase 22 alone: the solver farm
        federation, federation_place = federation_phase(smi)
        print("[timings] " + json.dumps({"federation": federation,
                                         "tas_place_sequential":
                                             federation_place}))
        print(smi)
        return 0

    if sys.argv[1:] == ["--phase", "20"]:
        # phase 20 alone, on phase 14's host-only store built afresh
        from kueue_oss_tpu_torch.api import types
        from kueue_oss_tpu_torch.core.queue_manager import QueueManager
        from kueue_oss_tpu_torch.core.store import Store
        from kueue_oss_tpu_torch.scenarios import tas_mixed_store
        from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler

        store = tas_mixed_store(types, Store)
        sched = Scheduler(store, QueueManager(store), device="cuda")
        sched.run_until_quiet(now=100.0, tick=0.001)
        dispatch, fills = dispatch_phase(smi, store, sched)
        print("[timings] " + json.dumps({"dispatch": dispatch,
                                         "fill_counts": fills}))
        print(smi)
        return 0

    mark("1-2")
    # 3. kernel vs plain
    device = torch.device("cuda")
    reports = [check_leaf_states(device), check_tas_place(device),
               check_fill_counts(device)]
    mark("3")

    # 4. stepwise placement, for the placement phase before the kernel
    step_phases, (step_tree, step_batch) = drain_with_stepwise_placer(
        device)
    mark("4")

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

    mark("5")
    # 6. the baseline preemption storm (FULL path, no TAS kernel)
    storm = storm_drain()
    mark("6")

    # 7. TAS with preemption (FULL path)
    tas_full, tas_full_launches = tas_full_drain()
    mark("7")

    # 8. the fair reclamation storm (FULL path, fair sharing)
    fair, fair_launches = fair_storm_drain()
    mark("8")

    # 9. the admission-fair-sharing backlog (FULL path, AFS)
    afs, afs_launches = afs_drain()
    mark("9")

    # 10. the storm under churn with delta sessions (FULL path)
    churn, churn_launches = storm_churn_drain()
    mark("10")

    # 11-13. the scheduler: the storm, the TAS store, a refused backlog
    sched_storm, sched_storm_launches = scheduler_storm()
    mark("11")
    sched_tas, sched_tas_launches, sched_tas_leaf = scheduler_tas()
    mark("12")
    sched_refused, sched_refused_launches = scheduler_refused()
    mark("13")

    # 14. the scheduler's host TAS placement and its device fill
    (sched_host, host_fill, host_leaf, host_place,
     (tas_store, tas_sched)) = scheduler_tas_host()
    mark("14")

    # 15. streaming admission: micro-drains through the lean drain on
    # the card, and serve with its watch-driven worker
    stream_fleets, stream_launches = streaming_fleets()
    stream_serve = streaming_serve()
    mark("15")

    # 16. the perf runner: Kueue's baseline run host only and auto, and
    # drain_benchmark at the large-scale size
    perf, perf_launches, (large_store, large_plan) = perf_runner(smi)
    mark("16")

    # 17. the what-if sweep: bench.py's shape batched, and the engine on
    # the baseline backlog
    whatif, whatif_launches = whatif_sweeps(smi)
    mark("17")

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
    mark("18")

    # 19. the FULL what-if sweep: the scenario-batched preemption drain,
    # lane-budgeted chunks with the relax tier, resident sweep state
    fullsweep, fullsweep_launches, fullsweep_relax = fullsweep_phase(
        smi)
    relax_report["launches"] += fullsweep_relax
    relax_report["launches_by_path"]["fullsweep"] = fullsweep_relax
    mark("19")

    # 20. the what-if-scored MultiKueue dispatch and the TAS controllers:
    # bench.py's fleet, the 8-worker pricing, node-failure recovery on
    # phase 14's store, the delayed TAS path, the flap trace; phase 21's
    # first sidecar process boots meanwhile
    import os
    import tempfile

    path_a = os.path.join(tempfile.mkdtemp(), "a.sock")
    sidecar_a = (path_a, start_sidecar(path_a))
    try:
        dispatch, dispatch_fills = dispatch_phase(smi, tas_store, tas_sched)
    except BaseException:
        sidecar_a[1].kill()
        sidecar_a[1].wait()
        raise
    del tas_store, tas_sched
    relax_report["launches_by_path"]["dispatch"] = 0
    mark("20")

    # 21. the solver sidecar: phase 10's storm through a sidecar process,
    # the scheduler's TAS entry point routed to it, the chaos storm and
    # the breaker
    sidecar, sidecar_place = sidecar_phase(
        smi, {d["label"]: d["sessions"]["drain_s"]
              for d in churn["drains"]}, sidecar=sidecar_a)
    # the sidecar path's 0 launches of relax_lp, leaf_states and
    # fill_counts are checked in sidecar_phase: the control plane in
    # (a)-(d), the sidecars by the launches they report on exit
    relax_report["launches_by_path"]["sidecar"] = 0
    mark("21")

    # 22. the solver farm: bench.py's federation phase 1 (4 tenants x 2
    # control planes, weighted DRR, isolation, eviction, throttling) and
    # a fleet at real size (phase 10's storm twice, phase 12's TAS
    # store) on one farm; its 0 launches of relax_lp, leaf_states and
    # fill_counts are checked in farm_contention (over all of (a)) and
    # fleet_real (over (b)'s threads)
    federation, federation_place = federation_phase(smi)
    relax_report["launches_by_path"]["federation"] = 0
    mark("22")
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
                                      "fullsweep": fullsweep_launches,
                                      "dispatch_node_failure":
                                          dispatch_fills["node_failure"],
                                      "dispatch_delayed_tas":
                                          dispatch_fills["delayed_tas"],
                                      "sidecar": 0, "federation": 0}
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
                                      "fullsweep": fullsweep_launches,
                                      "dispatch": 0, "sidecar": 0,
                                      "federation": 0}
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
                                      "fullsweep": fullsweep_launches,
                                      "dispatch": 0,
                                      "sidecar": sidecar_place,
                                      "federation": federation_place}

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
               "fullsweep": fullsweep, "dispatch": dispatch,
               "sidecar": sidecar, "federation": federation}
    print("[phase seconds] " + json.dumps(
        {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
        | {"total": marks[-1][1] - marks[0][1]}))
    print("[timings] " + json.dumps(timings))
    print(smi)
    print(json.dumps({"kernels": reports}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

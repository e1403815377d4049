"""Streaming control plane: micro-batched sub-cycle admission drains.

A copy of ``kueue_oss_tpu/scheduler/streaming.py``. The cycle-batch
model re-exports and re-solves the world every cycle, so at sustained
high arrival rates p50 time-to-admit is dominated by the full-solve
cadence — the batch-vs-continuous trade-off quantified in arXiv
1106.4985. This module decouples them: between full solves, new
arrivals to **uncontended** ClusterQueues are admitted sub-cycle
through a compact per-CQ fast path, while anything whose outcome could
depend on cross-CQ ordering defers to the next full solve.

Soundness model:

- A CQ is *fast-path eligible* only when the host flavor-assigner
  oracle fully models it sub-cycle: no preemption policies, no
  admission-scope AFS, no TAS flavors (and no fair sharing on the
  engine). For such CQs a greedy in-order walk of the pending heap —
  admit the head while the oracle says FIT, park BestEffortFIFO
  no-fits, stop at a blocked StrictFIFO head — is exactly the per-CQ
  behavior of the batched solve (the established kernel↔oracle
  parity).
- **Multi-flavor determinism.** With several flavor options, the
  batch oracle's pick for a workload depends on capacity margins: a
  capacity event landing later in the window (a finish freeing an
  earlier-preference flavor) would make the boundary solve pick a
  different flavor than the one already streamed — a retroactive
  divergence no fence can undo. So each pick is checked against a
  **flavor-pick witness** captured per full solve (the preference
  order plus static zero-usage capacity ceilings derived from the
  same spec data the solver exports — ``engine.flavor_witness()`` /
  ``tensors.flavor_option_ceilings``, cached by
  ``ExportCache.spec_gen``): a pick streams only when every
  earlier-preference compatible option's ceiling sits below the
  request, i.e. no capacity event can flip it; otherwise the CQ
  demotes (``flavor_witness_invalid``).
- Cross-CQ coupling happens only through cohort **borrowing**, and
  the batch oracle interleaves cohort-mates in global priority
  order. Singleton cohort subtrees stream freely (their borrowing
  races nobody) and no-borrow subtrees are capacity-independent. A
  borrow-capable multi-CQ subtree streams under the
  **reserved-headroom protocol**: each full solve reserves a per-CQ
  nominal-headroom budget (the CQ's unused nominal at the boundary);
  sub-cycle admissions consume only that budget — never borrowed
  capacity (borrowing stays a full-solve-only decision, the Aryl
  capacity-loaning contract, arXiv 2202.07896) — and the subtree's
  members are walked as ONE merged sequence in global order (the
  batch interleave). Within-nominal admissions are order-independent
  across mates, so the merged prefix matches the boundary solve
  bit-for-bit; the first entry that would need borrowed capacity (or
  overruns its budget) fences the whole subtree
  (``headroom_exhausted``) until the next full solve resolves the
  borrow jointly.
- On top of that, any cohort-crossing event — an eviction/finish/
  preemption candidate (capacity freed), a quota or flavor edit, a
  node flap (all spec events bump ``ExportCache.spec_gen``), an
  admission by any other path — marks the subtree **contended** until
  the next full solve.
- Within one CQ, the cycle-batch oracle reorders a whole inter-solve
  window by ``_order_key`` (priority, then FIFO). Streaming admits in
  arrival order, which matches the batch order exactly while arrivals
  are order-monotone; an **out-of-order arrival** (one sorting before
  a workload already admitted this window) demotes the CQ before it
  is processed.

Under those fences the final store state after each full solve is
bit-identical to the pure cycle-batch oracle. Commits reuse
``SolverEngine._commit_admission``, so a streaming admission is
indistinguishable in the store from a batched one; it dirties its
``ExportCache`` row like any other store event, and the next full solve
ships it as a normal dirty-row delta (no session reset, resident device
tensors untouched).

**Device micro-solve.** A watch-driven burst large enough to amortize
a kernel dispatch (``micro_solve_min`` eligible entries across the
streamable single-flavor CQs) is coalesced into ONE lean-drain solve
on the engine's device (``_drain_micro``): per-entry fences are
re-checked host-side while building the batch, the export pins the
window snapshot (so earlier streamed usage is visible), and the plan
decodes through the same opt->flavor mapping as
``SolverEngine._apply_plan``. Small bursts and multi-flavor CQs keep the
per-entry host FlavorAssigner walk — the small-burst path and the
micro-solve's parity oracle (``KUEUE_STREAM_MICROSOLVE=0`` forces it
everywhere).

The admitter keeps ``counts`` under the JAX package's stream metric
names (``stream_admitted_total``, ``stream_demotions_total`` by reason,
``stream_microdrains_total`` by outcome, ``stream_eligible_fraction``,
and ``stream_spec_solves_total``, which the scheduler's serve loop
bumps), each equal to its series in the metrics registry. The
flight recorder gets the fence events (``_fence_event``,
``_note_structural``) and the streamed parkings; a productive
micro-drain records a ``STREAM_DRAIN`` ledger row. The fences report
into the degradation ladder's STREAMING subsystem: a full fence (an
unresolvable event owner, a spec change mid-window) raises
``stream_off`` and a completed full solve clears it; deferred CQs raise
``structural_fence``, and a clean drain or a solve that cleared every
contended root clears it. A productive micro-drain ends in the attached
``PersistenceManager``'s group commit. Cut from the copy: the
concurrent-admission variant fence (the port's Workload has no ``parent_workload``), and what
nothing in the port sets or reads: the admitter's ``enabled`` switch
(the scheduler's ``_streaming_on`` decides whether an admitter exists)
and ``MicroDrainResult``'s ``commit_s`` wall.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from kueue_oss_tpu_torch import features, metrics, obs, resilience
from kueue_oss_tpu_torch.api.types import (
    FlavorFungibilityPolicy,
    QueueingStrategy,
)
from kueue_oss_tpu_torch.core.queue_manager import _order_key
from kueue_oss_tpu_torch.core.snapshot import build_snapshot
from kueue_oss_tpu_torch.core.workload_info import WorkloadInfo
from kueue_oss_tpu_torch.scheduler import flavor_assigner as fa
from kueue_oss_tpu_torch.scheduler.flavor_assigner import FlavorAssigner
from kueue_oss_tpu_torch.scheduler.preemption import Preemptor
from kueue_oss_tpu_torch.solver.kernels import solve_backlog, to_device
from kueue_oss_tpu_torch.solver.ops import INT32
from kueue_oss_tpu_torch.solver.tensors import (
    ExportCache,
    export_problem,
    pad_workloads,
)


@dataclass
class MicroDrainResult:
    """Outcome of one micro-batched admission drain."""

    admitted: int = 0
    parked: int = 0
    duration_s: float = 0.0
    #: CQs skipped this drain because their subtree is contended, a
    #: sibling holds pending work, or an entry needs the full solve
    deferred_cqs: int = 0
    admitted_keys: list[str] = field(default_factory=list)
    #: entries routed through the device micro-solve (0 = host walk)
    micro_batch: int = 0
    micro_export_s: float = 0.0
    micro_solve_s: float = 0.0


_FENCE_TEXT = {
    "out_of_order": (
        "demoted from the streaming fast path: the arrival sorts "
        "before an admission already committed this window, so only "
        "the full solve can honor batch priority order"),
    "unsupported": (
        "deferred to the full solve: workload shape outside the "
        "streaming fast path (topology request, concurrent-admission "
        "variant, or multi-podset flavor choice)"),
    "flavor_witness_invalid": (
        "demoted from the streaming fast path: an earlier-preference "
        "flavor option stays reachable under its capacity ceiling, "
        "so a capacity event could flip the batch oracle's pick"),
    "headroom_exhausted": (
        "demoted from the streaming fast path: the admission would "
        "need borrowed capacity or overrun the reserved "
        "nominal-headroom budget (borrowing is a full-solve-only "
        "decision)"),
    "borrow_capable": (
        "deferred to the full solve: borrow-capable cohort subtree "
        "with a member outside the streaming fast path"),
    "ineligible": (
        "deferred to the full solve: the ClusterQueue uses "
        "preemption, AdmissionFairSharing, TAS flavors, or "
        "non-default flavor fungibility"),
}


class StreamingAdmitter:
    """Per-CQ sub-cycle admission fast path between full solves.

    One instance per SolverEngine; ``drain()`` runs on the scheduler
    thread, the store-watch classifier may run on any mutating thread
    (controller callbacks), so the contention sets are lock-guarded.
    """

    def __init__(self, store, queues, engine,
                 max_batch: int = 512) -> None:
        self.store = store
        self.queues = queues
        self.engine = engine
        #: admissions per drain() call — bounds one micro-batch's
        #: latency; the remainder stays in order for the next drain
        self.max_batch = max_batch
        #: device micro-solve: coalesce a watch-driven burst into ONE
        #: lean-drain solve instead of per-entry host oracle walks.
        #: The host walk stays as the small-burst path and the parity
        #: oracle (KUEUE_STREAM_MICROSOLVE=0 forces it everywhere).
        self.micro_solve = os.environ.get(
            "KUEUE_STREAM_MICROSOLVE", "1") != "0"
        #: bursts below this many pending entries stay on the host
        #: walk — kernel dispatch overhead dominates tiny batches
        self.micro_solve_min = int(os.environ.get(
            "KUEUE_STREAM_MICROSOLVE_MIN", "64"))
        #: sticky pow2 pad target for micro-solve exports (the lean
        #: drain's round bound follows the padded workload axis, so a
        #: pad that only grows keeps the bound monotone, as the JAX
        #: package's recompile guard does)
        self._micro_hwm = 0
        #: subscribed ExportCache for micro-solve exports (memoized
        #: row building); its columnar view is disabled — the micro
        #: path always exports classic against the pinned window
        #: snapshot
        self._micro_cache = None
        #: a full solve must have completed since the last contending
        #: epoch before any micro-drain runs (the parity baseline)
        self.armed = False
        #: ExportCache.spec_gen at arm time — ANY spec event (quota
        #: edit, flavor change, node flap, cohort edit) bumps it, which
        #: fences the whole window (tensors.py dirty tracking)
        self._armed_gen = -1
        self._mu = threading.Lock()
        #: cohort roots contended since the last full solve, stamped
        #: with the fence generation they were raised at — a full
        #: solve clears only fences raised BEFORE it began, so an
        #: event landing mid-solve (which the solve's export never
        #: saw) keeps its subtree fenced for the next one
        self._contended_roots: dict[str, int] = {}
        self._gen = 0
        self._solve_mark = 0
        self._solve_spec_gen = -1
        #: thread running the current full solve: its events (plan
        #: commits, plan evictions) ARE the solve — they land in the
        #: boundary state and must not fence the next window
        self._solve_thread: Optional[int] = None
        #: per-spec-gen derived tables: cq -> root key, root -> members
        self._root_gen = -1
        self._root_of: dict[str, str] = {}
        self._members: dict[str, list[str]] = {}
        #: roots whose subtree structure permits free per-CQ streaming
        #: (singleton, or borrowing disabled throughout)
        self._root_streamable: dict[str, bool] = {}
        #: borrow-capable multi-CQ roots whose members are ALL
        #: statically eligible — these stream through the merged-order
        #: reserved-headroom walk instead of deferring outright
        self._root_merge_ok: dict[str, bool] = {}
        self._eligible_cache: dict[str, bool] = {}
        self._multi_flavor_cache: dict[str, bool] = {}
        #: static zero-usage capacity ceilings per CQ flavor option —
        #: the flavor-pick witness (engine.flavor_witness, cached per
        #: spec generation)
        self._flavor_ceilings: dict[str, dict] = {}
        #: reserved nominal-headroom budgets, cq -> fr -> remaining;
        #: captured from the window snapshot at first touch after each
        #: full solve and drawn down by merged-walk commits
        self._headroom: dict[str, dict] = {}
        #: newest merged-order key admitted per borrow-capable root
        #: this window (the cross-CQ out-of-order fence)
        self._root_floor: dict[str, tuple] = {}
        #: structural fences already recorded to the flight recorder
        #: this spec generation (explain support, one event per cause)
        self._fence_noted: set[tuple[str, str]] = set()
        #: watch-driven drain support: the serve loop registers a
        #: notifier; _on_event signals it on every streamable arrival
        #: so micro-drain latency is event-bound, not tick-bound
        self._notify = None
        self._signal_pending = 0
        #: window snapshot for oracle fit checks, built lazily at the
        #: first micro-drain after arm and mutated incrementally by our
        #: own admissions (contended subtrees never consult it)
        self._snap = None
        #: newest _order_key admitted per CQ this window (the
        #: out-of-order arrival fence)
        self._max_admitted: dict[str, tuple] = {}
        #: thread id whose commit events are self-classification to
        #: suppress — thread-SCOPED, not a process-wide flag: a
        #: controller thread's capacity event arriving mid-commit
        #: must still contend its root
        self._committing_thread: Optional[int] = None
        self._preemptor = Preemptor(enable_fair_sharing=False)
        #: a spec edit (quota/flavor change, node flap) observed
        #: mid-window doesn't just fence the window — it requests the
        #: full solve be pulled FORWARD (the serve loop consumes this
        #: and runs the heavy cycle now): the edit changed capacity
        #: the parked/pending backlog may now fit (or no longer fit),
        #: and waiting out the cadence would serve stale answers
        self.full_solve_pending = False
        #: the JAX package's stream metrics, under their names:
        #: admissions, demotions by reason, micro-drains by outcome,
        #: the last drain's eligible fraction, spec-pulled full solves
        self.counts = {
            "stream_admitted_total": 0,
            "stream_demotions_total": collections.Counter(),
            "stream_microdrains_total": collections.Counter(),
            "stream_eligible_fraction": 0.0,
            "stream_spec_solves_total": 0,
        }
        store.watch(self._on_event)

    def count(self, name: str, label: Optional[str] = None,
              by: int = 1) -> None:
        """Bump one of ``counts`` (by label for the labelled ones);
        callers on any thread."""
        with self._mu:
            if label is None:
                self.counts[name] += by
            else:
                self.counts[name][label] += by
        series = getattr(metrics, name)
        if label is None:
            series.inc(by=float(by))
        else:
            series.inc(label, by=float(by))

    # -- event classification (the safety fence) ---------------------------

    def _on_event(self, event) -> None:
        ident = threading.get_ident()
        if self._committing_thread == ident:
            return  # our own commit: tracked via _max_admitted/_snap
        if self._solve_thread == ident:
            # the full solve's own plan application: part of the
            # boundary state note_full_solve re-arms against
            return
        verb, kind, obj = event
        if kind != "Workload":
            # spec events ride ExportCache.spec_gen (checked per
            # drain); nothing to classify here
            return
        wl = obj
        if (verb != "delete" and wl.active and not wl.is_quota_reserved
                and not wl.is_finished and not wl.is_evicted
                and wl.status.admission is None):
            # pure pending arrival/update: the work we stream — wake
            # the watch-driven drain worker instead of waiting for the
            # serve loop's next tick
            with self._mu:
                self._signal_pending += 1
                cb = self._notify
            if cb is not None:
                cb()
            return
        cq = self.store.cluster_queue_for(wl)
        if cq is None and wl.status.admission is not None:
            cq = wl.status.admission.cluster_queue
        self._contend(cq, "cohort_event")

    def set_arrival_notifier(self, cb) -> None:
        """Register the watch-driven drain wakeup (serve loop). The
        callback runs on the mutating thread — it must only signal."""
        with self._mu:
            self._notify = cb

    def take_arrival_signals(self) -> int:
        """Number of arrival signals since the last take — the drain
        worker coalesces a burst of N signals into one drain and
        accounts the other N-1 as ``watch_coalesced``."""
        with self._mu:
            n = self._signal_pending
            self._signal_pending = 0
            return n

    def _contend(self, cq: Optional[str], reason: str) -> None:
        with self._mu:
            self._gen += 1
            if cq is None:
                # unresolvable owner: fence everything (rare — a
                # deleted LQ mid-flight)
                self.armed = False
            else:
                self._contended_roots[self._root(cq)] = self._gen
        self.count("stream_demotions_total", reason)
        if cq is None:
            resilience.controller.report(
                resilience.STREAMING, "stream_off", True,
                reason=f"window disarmed ({reason}): event owner "
                       "unresolvable; full fence")

    # -- per-spec-gen derived tables ---------------------------------------

    def _refresh_tables(self) -> None:
        gen = self.engine.export_cache.spec_gen
        if self._root_gen == gen:
            return
        self._root_gen = gen
        self._root_of = {}
        self._members = {}
        self._eligible_cache = {}
        self._multi_flavor_cache = {}
        self._fence_noted = set()
        #: the flavor-pick witness for this spec generation (static
        #: zero-usage ceilings the multi-flavor fence checks against)
        self._flavor_ceilings = self.engine.flavor_witness()
        roots: dict[str, str] = {}

        def root_of_cohort(name: str) -> str:
            if name in roots:
                return roots[name]
            seen = set()
            cur = name
            while True:
                if cur in seen:
                    break
                seen.add(cur)
                spec_c = self.store.cohorts.get(cur)
                if spec_c is None or not spec_c.parent:
                    break
                cur = spec_c.parent
            roots[name] = cur
            return cur

        for name, spec in self.store.cluster_queues.items():
            root = (f"cohort:{root_of_cohort(spec.cohort)}"
                    if spec.cohort else f"cq:{name}")
            self._root_of[name] = root
            self._members.setdefault(root, []).append(name)
        # structural borrowing fence: a multi-CQ subtree streams only
        # when NO member can borrow (zero borrowing limits => the
        # members are capacity-independent and per-CQ greedy order is
        # the joint batch order); a singleton subtree always may (its
        # borrowing races nobody)
        self._root_streamable = {}
        for root, members in self._members.items():
            if len(members) == 1:
                self._root_streamable[root] = True
                continue
            self._root_streamable[root] = all(
                not _can_borrow(self.store.cluster_queues[m])
                for m in members)
        # borrow-capable multi-CQ subtrees stream via the merged-order
        # reserved-headroom walk — but only when every member is
        # statically eligible (one ineligible member's full-solve
        # admissions would interleave with streamed ones)
        self._root_merge_ok = {}
        for root, members in self._members.items():
            if self._root_streamable[root]:
                continue
            self._root_merge_ok[root] = all(
                self._static_eligible(m) for m in members)

    def _root(self, cq: str) -> str:
        self._refresh_tables()
        return self._root_of.get(cq, f"cq:{cq}")

    def _static_eligible(self, name: str) -> bool:
        """Oracle-modelable CQ (cached per spec generation): no
        preemption, no admission-scope AFS, no TAS flavors. Multi-
        flavor-option CQs are eligible — the per-pick flavor witness
        (``_pick_stable``) guards their determinism at walk time —
        but only under the DEFAULT flavor fungibility: a non-default
        early-stop policy (TryNextFlavor on borrow, preemption
        preference) makes the pick depend on capacity margins of
        LATER flavors too, which the zero-usage witness cannot
        bound."""
        cached = self._eligible_cache.get(name)
        if cached is not None:
            return cached
        spec = self.store.cluster_queues.get(name)
        ok = (spec is not None
              and not spec.preemption.any_enabled
              and not (spec.admission_scope is not None
                       and self.queues.afs is not None)
              and not self.engine._is_tas_cq(name))
        if ok and self._cq_multi_flavor(name) and features.enabled(
                "FlavorFungibility"):
            fung = spec.flavor_fungibility
            ok = (fung.when_can_borrow == FlavorFungibilityPolicy.BORROW
                  and fung.when_can_preempt
                  == FlavorFungibilityPolicy.TRY_NEXT_FLAVOR
                  and fung.preference is None)
        self._eligible_cache[name] = ok
        return ok

    def _cq_multi_flavor(self, name: str) -> bool:
        """Whether any resource group of this CQ offers a flavor
        choice (cached per spec generation)."""
        cached = self._multi_flavor_cache.get(name)
        if cached is not None:
            return cached
        spec = self.store.cluster_queues.get(name)
        multi = (spec is not None and any(
            len(rg.flavors) > 1 for rg in spec.resource_groups))
        self._multi_flavor_cache[name] = multi
        return multi

    # -- window lifecycle --------------------------------------------------

    def note_solve_begin(self) -> None:
        """Called by the engine right before a full solve: records
        the fence generation and spec generation the solve's export
        can possibly cover. Events landing after this mark survive
        note_full_solve — the solve never saw them."""
        with self._mu:
            self._solve_mark = self._gen
            self._solve_spec_gen = self.engine.export_cache.spec_gen
            self._solve_thread = threading.get_ident()

    def note_full_solve(self) -> None:
        """A full solve completed: fences raised before it began
        reset and the next window opens against the post-solve store
        (the oracle-parity baseline boundary). Fences and spec bumps
        from mid-solve events stay — they defer to the NEXT solve."""
        with self._mu:
            self.armed = True
            self._armed_gen = self._solve_spec_gen
            self._solve_thread = None
            self._contended_roots = {
                root: g for root, g in self._contended_roots.items()
                if g > self._solve_mark}
            self._snap = None
            self._max_admitted.clear()
            # the boundary re-reserves the headroom budgets and
            # resets the merged-order floors: the new window opens
            # against post-solve usage
            self._headroom.clear()
            self._root_floor.clear()
            contended = bool(self._contended_roots)
        # degradation ladder: a completed full solve re-arms the window
        # (stream_off clears); structural fences survive only for roots
        # contended mid-solve
        ctl = resilience.controller
        if ctl.active(resilience.STREAMING, "stream_off"):
            ctl.report(resilience.STREAMING, "stream_off", False,
                       reason="full solve completed; window re-armed")
        if not contended and ctl.active(resilience.STREAMING,
                                        "structural_fence"):
            ctl.report(resilience.STREAMING, "structural_fence", False,
                       reason="full solve cleared every contended root")

    def note_solve_abort(self) -> None:
        """The solve failed (host fallback): stop attributing events
        to it; every fence it raised stays down until a COMPLETED
        solve re-arms."""
        with self._mu:
            self._solve_thread = None

    def _window_snapshot(self):
        if self._snap is None:
            self._snap = build_snapshot(self.store,
                                        device=self.engine.device)
        return self._snap

    # -- the micro-drain ---------------------------------------------------

    def drain(self, now: float = 0.0) -> MicroDrainResult:
        """Admit in-order arrivals for every uncontended fast-path CQ.

        Runs between full solves; O(pending-in-eligible-CQs), never
        O(store) beyond the one lazily built window snapshot."""
        result = MicroDrainResult()
        if not self.armed:
            return result
        if self.engine.enable_fair_sharing:
            return result
        if self.engine.export_cache.spec_gen != self._armed_gen:
            # quota edit / flavor change / node flap since arm: fence
            # the whole window AND request an immediate full solve —
            # consume_full_solve_request() tells the serve loop to run
            # the heavy cycle now rather than on its natural cadence
            with self._mu:
                self.armed = False
                self.full_solve_pending = True
            self.count("stream_demotions_total", "spec_change")
            resilience.controller.report(
                resilience.STREAMING, "stream_off", True,
                reason="spec generation changed mid-window; streaming "
                       "disarmed pending a full solve")
            return result
        t0 = time.perf_counter()
        pending = self.queues.cqs_with_pending()
        if not pending:
            self.count("stream_microdrains_total", "idle")
            return result
        self._refresh_tables()
        with self._mu:
            contended = set(self._contended_roots)
        considered = 0
        by_root: dict[str, list[str]] = {}
        for name in pending:
            root = self._root_of.get(name, f"cq:{name}")
            by_root.setdefault(root, []).append(name)
        #: streamable CQs this drain, routed by burst size: large
        #: coalesced bursts go through ONE device micro-solve, small
        #: ones (and every multi-flavor CQ) through the host walk
        micro_cqs: list[tuple[str, str]] = []
        host_cqs: list[tuple[str, str]] = []
        for root, names in by_root.items():
            if result.admitted + result.parked >= self.max_batch:
                break
            considered += len(names)
            if root in contended:
                result.deferred_cqs += len(names)
                continue
            flooded = False
            for name in names:
                q = self.queues.queues.get(name)
                if (q is not None
                        and len(q._in_heap) > 4 * self.max_batch):
                    # a flood-sized heap is the batched solver's job
                    # (the scheduler's solver_min_backlog routing);
                    # walking it entry-by-entry here would stall the
                    # serve loop
                    flooded = True
                    break
            if flooded:
                result.deferred_cqs += len(names)
                continue
            if self._root_streamable.get(root, False):
                for name in names:
                    if not self._static_eligible(name):
                        result.deferred_cqs += 1
                        self._note_structural(name, "ineligible")
                        continue
                    # single-flavor CQs may batch into the device
                    # micro-solve; multi-flavor picks stay on the
                    # host walk where the per-pick witness
                    # (_pick_stable) guards their determinism
                    if (self.micro_solve
                            and not self._cq_multi_flavor(name)):
                        micro_cqs.append((name, root))
                    else:
                        host_cqs.append((name, root))
                continue
            # borrow-capable multi-CQ subtree: streams through the
            # merged-order reserved-headroom walk when every member
            # is statically eligible; otherwise only the full solve
            # reproduces the joint order
            if not self._root_merge_ok.get(root, False):
                result.deferred_cqs += len(names)
                self.count("stream_demotions_total", "borrow_capable")
                for name in names:
                    self._note_structural(name, "borrow_capable")
                continue
            if not self._drain_root(root, names, now, result):
                contended.add(root)  # demoted mid-walk
        if micro_cqs:
            total = sum(
                len(q._in_heap) for q in
                (self.queues.queues.get(n) for n, _ in micro_cqs)
                if q is not None)
            if total >= self.micro_solve_min:
                self._drain_micro(micro_cqs, now, result, contended)
            else:
                # small burst: the per-entry host oracle walk is
                # cheaper than a kernel dispatch (and doubles as the
                # micro-solve's parity oracle)
                host_cqs = micro_cqs + host_cqs
        for name, root in host_cqs:
            if root in contended:
                continue
            if result.admitted + result.parked >= self.max_batch:
                break
            if not self._drain_cq(name, root, now, result):
                contended.add(root)  # demoted mid-walk
        if considered:
            frac = max(0.0, 1.0 - result.deferred_cqs / considered)
            with self._mu:
                self.counts["stream_eligible_fraction"] = frac
            metrics.stream_eligible_fraction.set(value=frac)
        result.duration_s = time.perf_counter() - t0
        self.count(
            "stream_microdrains_total",
            "admitted" if result.admitted else
            ("parked" if result.parked else
             ("deferred" if result.deferred_cqs else "idle")))
        # degradation ladder: deferrals mean part of the fleet runs on
        # the structural (full-solve-only) rung; a clean drain over a
        # non-empty set recovers it
        ctl = resilience.controller
        if result.deferred_cqs:
            ctl.report(
                resilience.STREAMING, "structural_fence", True,
                reason=f"{result.deferred_cqs} CQ(s) deferred to the "
                       "next full solve behind structural fences")
        elif considered and ctl.active(resilience.STREAMING,
                                       "structural_fence"):
            ctl.report(resilience.STREAMING, "structural_fence", False,
                       reason="micro-drain covered every eligible CQ")
        if result.admitted:
            self._record_ledger(result)
            p = getattr(self.store, "persistence", None)
            if p is not None:
                # sub-cycle durability barrier: the micro-batch's
                # intents and events group-commit now, and the
                # checkpoint cadence gets its look
                p.flush()
        return result

    def _drain_cq(self, name: str, root: str, now: float,
                  result: MicroDrainResult) -> bool:
        """Greedy in-order walk of one CQ's heap. Returns False when
        the CQ demoted itself (out-of-order arrival, preempt-needed,
        unsupported shape) — the caller fences its root for the rest
        of this drain; the sticky fence rides ``_contended_roots``."""
        q = self.queues.queues.get(name)
        if q is None:
            return True
        strict = q.strategy == QueueingStrategy.STRICT_FIFO
        snap = self._window_snapshot()
        cq_snap = snap.cluster_queue(name)
        if cq_snap is None:
            return True
        floor = self._max_admitted.get(name)
        multi = self._cq_multi_flavor(name)
        for info in q.snapshot_order():
            # max_batch bounds PROCESSED entries (admits + parks), not
            # just admissions — one micro-drain must never walk an
            # unbounded no-fit backlog; the remainder keeps its order
            # for the next tick (or the full solve)
            if result.admitted + result.parked >= self.max_batch:
                return True
            with self._mu:
                # live fence re-check per entry: a controller thread
                # may contend this root mid-walk (capacity freed);
                # committing past that point would stream into state
                # the batch oracle would re-order
                if root in self._contended_roots or not self.armed:
                    return True
            key = _order_key(info)
            if floor is not None and key < floor:
                # out-of-order arrival: the batch oracle would have
                # sorted it before admissions already committed this
                # window — demote before processing it
                self._fence_event(info.key, name, "out_of_order")
                self._contend(name, "out_of_order")
                return False
            wl = self.store.workloads.get(info.key)
            if wl is None or wl.is_quota_reserved or not wl.active:
                continue
            if any(ps.topology_request is not None for ps in wl.podsets):
                self._fence_event(info.key, name, "unsupported",
                                  {"check": "topology_request"})
                self._contend(name, "unsupported")
                return False
            if multi and len(wl.podsets) > 1:
                # the flavor witness bounds single-podset picks only:
                # grouped multi-podset assignment shares flavors in
                # ways the per-resource ceilings don't model
                self._fence_event(info.key, name, "unsupported",
                                  {"check": "multi_flavor_multi_podset"})
                self._contend(name, "unsupported")
                return False
            fresh = WorkloadInfo(wl, cluster_queue=name)
            assigner = FlavorAssigner(
                fresh, cq_snap, snap.resource_flavors,
                oracle=self._preemptor, enable_fair_sharing=False)
            assignment = assigner.assign()
            mode = assignment.representative_mode()
            if mode == fa.FIT:
                if multi and not self._pick_stable(
                        name, wl, cq_snap, snap, assignment):
                    self._fence_event(
                        info.key, name, "flavor_witness_invalid")
                    self._contend(name, "flavor_witness_invalid")
                    return False
                self._commit(wl, name, fresh, assignment, now, result)
                floor = key
                self._max_admitted[name] = key
                continue
            # NO_FIT, or PREEMPT on a CQ whose policies are all Never
            # (static eligibility excludes preemption-capable CQs, so
            # "fits only by preempting" is a lean-drain park) —
            # kernel parity: BestEffortFIFO parks and walks on; a
            # blocked StrictFIFO head blocks the queue
            if strict:
                return True
            q.park(info.key)
            result.parked += 1
            obs.recorder.record(
                obs.SKIPPED, info.key, cycle=self._cycle(),
                cluster_queue=name, path=obs.STREAM,
                reason="parked inadmissible by the streaming fast "
                       "path: no flavor option fits at current "
                       "capacity",
                reason_slug="stream_parked")
        return True

    def _drain_root(self, root: str, names: list[str], now: float,
                    result: MicroDrainResult) -> bool:
        """Merged-order walk of a borrow-capable multi-CQ subtree
        under the reserved-headroom protocol: every member's pending
        entries are walked as one sequence in global ``_order_key``
        order (the batch oracle's cohort interleave), each admission
        must fit its CQ's reserved nominal-headroom budget with a
        zero borrowing level, and the first entry that would need
        borrowed capacity fences the subtree to the full solve.
        Returns False when the subtree demoted itself mid-walk."""
        snap = self._window_snapshot()
        entries: list[tuple] = []
        lanes: dict[str, tuple] = {}
        for name in names:
            q = self.queues.queues.get(name)
            if q is None:
                continue
            cq_snap = snap.cluster_queue(name)
            if cq_snap is None:
                continue
            # reserve the budget before the first commit can land
            self._headroom_budget(name, cq_snap)
            lanes[name] = (q, cq_snap)
            for info in q.snapshot_order():
                entries.append((name, info))
        entries.sort(key=lambda e: _order_key(e[1]))
        blocked: set[str] = set()
        floor = self._root_floor.get(root)
        for name, info in entries:
            if result.admitted + result.parked >= self.max_batch:
                return True
            if name in blocked:
                continue
            with self._mu:
                if root in self._contended_roots or not self.armed:
                    return True
            q, cq_snap = lanes[name]
            key = _order_key(info)
            if floor is not None and key < floor:
                # cross-CQ out-of-order arrival: the batch oracle
                # would interleave it before an admission another
                # member already committed this window
                self._fence_event(info.key, name, "out_of_order")
                self._contend(name, "out_of_order")
                return False
            wl = self.store.workloads.get(info.key)
            if wl is None or wl.is_quota_reserved or not wl.active:
                continue
            if any(ps.topology_request is not None
                   for ps in wl.podsets):
                self._fence_event(info.key, name, "unsupported",
                                  {"check": "topology_request"})
                self._contend(name, "unsupported")
                return False
            multi = self._cq_multi_flavor(name)
            if multi and len(wl.podsets) > 1:
                self._fence_event(info.key, name, "unsupported",
                                  {"check": "multi_flavor_multi_podset"})
                self._contend(name, "unsupported")
                return False
            fresh = WorkloadInfo(wl, cluster_queue=name)
            assigner = FlavorAssigner(
                fresh, cq_snap, snap.resource_flavors,
                oracle=self._preemptor, enable_fair_sharing=False)
            assignment = assigner.assign()
            mode = assignment.representative_mode()
            if mode == fa.FIT:
                if (assignment.borrows()
                        or not self._headroom_admits(name, assignment)):
                    # the admission would consume borrowed capacity
                    # (or overrun the reserved budget): borrowing is
                    # a full-solve-only decision — fence the subtree
                    # until the next solve resolves it jointly
                    self._fence_event(
                        info.key, name, "headroom_exhausted",
                        {"borrows": assignment.borrows()})
                    self._contend(name, "headroom_exhausted")
                    return False
                if multi and not self._pick_stable(
                        name, wl, cq_snap, snap, assignment):
                    self._fence_event(
                        info.key, name, "flavor_witness_invalid")
                    self._contend(name, "flavor_witness_invalid")
                    return False
                self._headroom_consume(name, assignment)
                self._commit(wl, name, fresh, assignment, now, result)
                floor = key
                self._root_floor[root] = key
                prev = self._max_admitted.get(name)
                if prev is None or key > prev:
                    self._max_admitted[name] = key
                continue
            # NO_FIT / lean-drain park: a blocked StrictFIFO head
            # blocks only its own lane — the batch interleave keeps
            # walking the other members
            if q.strategy == QueueingStrategy.STRICT_FIFO:
                blocked.add(name)
                continue
            q.park(info.key)
            result.parked += 1
            obs.recorder.record(
                obs.SKIPPED, info.key, cycle=self._cycle(),
                cluster_queue=name, path=obs.STREAM,
                reason="parked inadmissible by the streaming fast "
                       "path: no flavor option fits at current "
                       "capacity",
                reason_slug="stream_parked")
        return True

    # -- device micro-solve ------------------------------------------------

    def _micro_export_cache(self):
        if self._micro_cache is None:
            self._micro_cache = ExportCache(self.store)
            # micro exports always run classic against the pinned
            # window snapshot; drop the columnar view so this cache
            # only pays for memoized row building
            self._micro_cache.columnar = None
        return self._micro_cache

    def _drain_micro(self, cqs: list[tuple[str, str]], now: float,
                     result: MicroDrainResult,
                     contended: set[str]) -> None:
        """Batch a streamed burst into ONE lean-drain micro-solve on
        the engine's device.

        Every per-entry fence the host walk applies (out-of-order
        floor, topology request) is re-checked host-side while
        building the batch, and the drain's plan decodes through the
        same opt -> flavor mapping as ``SolverEngine._apply_plan`` — so
        the committed store state is bit-identical to walking the same
        entries through the host FlavorAssigner (the small-burst path
        below ``micro_solve_min``, which doubles as the parity
        oracle). Multi-flavor CQs never route here; their picks keep
        the per-pick witness on the host path. The export pins the
        window snapshot, so usage from this window's earlier streamed
        commits is visible to the drain exactly as the host oracle
        would see it, and no delta session or resident device state is
        touched (the admissions dirty their ExportCache rows like any
        other store event and ship as normal deltas next full solve).
        A device error propagates: there is no host retry.
        """
        t0 = time.perf_counter()
        snap = self._window_snapshot()
        budget = self.max_batch - (result.admitted + result.parked)
        batch: dict[str, list[WorkloadInfo]] = {}
        root_of_batch: dict[str, str] = {}
        for name, root in cqs:
            if budget <= 0:
                break
            if root in contended:
                result.deferred_cqs += 1
                continue
            q = self.queues.queues.get(name)
            if q is None or snap.cluster_queue(name) is None:
                continue
            floor = self._max_admitted.get(name)
            infos: list[WorkloadInfo] = []
            demoted = False
            for info in q.snapshot_order():
                if len(infos) >= budget:
                    break
                key = _order_key(info)
                if floor is not None and key < floor:
                    self._fence_event(info.key, name, "out_of_order")
                    self._contend(name, "out_of_order")
                    contended.add(root)
                    demoted = True
                    break
                wl = self.store.workloads.get(info.key)
                if wl is None or wl.is_quota_reserved or not wl.active:
                    continue
                if any(ps.topology_request is not None
                       for ps in wl.podsets):
                    self._fence_event(info.key, name, "unsupported",
                                      {"check": "topology_request"})
                    self._contend(name, "unsupported")
                    contended.add(root)
                    demoted = True
                    break
                infos.append(info)
            if demoted or not infos:
                continue
            batch[name] = infos
            root_of_batch[name] = root
            budget -= len(infos)
        if not batch:
            return
        problem = export_problem(
            self.store, batch, snapshot=snap, now=now,
            cache=self._micro_export_cache(), columnar=False)
        W = problem.n_workloads
        if not W:
            return
        target = 1 << max(6, (W - 1).bit_length())
        self._micro_hwm = max(self._micro_hwm, target)
        padded = pad_workloads(problem, self._micro_hwm)
        t1 = time.perf_counter()
        out = solve_backlog(to_device(padded, self.engine.device))
        # one read-back of the four plan vectors
        plan = torch.stack([a.to(INT32) for a in out[:4]]).cpu().numpy()
        admitted, parked = plan[0].astype(bool), plan[3].astype(bool)
        opt, admit_round = plan[1], plan[2]
        t2 = time.perf_counter()
        result.micro_batch += W
        result.micro_export_s += t1 - t0
        result.micro_solve_s += t2 - t1
        self._commit_plan(padded, admitted, opt, admit_round, parked,
                          root_of_batch, now, result)

    def _commit_plan(self, problem, admitted, opt, admit_round,
                     parked, root_of_batch: dict[str, str],
                     now: float, result: MicroDrainResult) -> None:
        """Decode and commit the micro-solve plan — the streaming
        twin of ``SolverEngine._apply_plan``: admissions in (round,
        entry) order through the engine commit, the drain's park
        decisions mirrored into the heaps, StrictFIFO blocked heads
        untouched."""
        W = problem.n_workloads
        adm = np.nonzero(admitted[:-1])[0]
        order = adm[np.argsort(admit_round[adm], kind="stable")]
        declared_of: dict[str, set] = {}
        for w in order:
            key = problem.wl_keys[w]
            if not key:
                continue
            name = problem.cq_names[problem.wl_cqid[w]]
            root = root_of_batch.get(name)
            if root is None:
                continue
            with self._mu:
                # live fence re-check per commit: a controller thread
                # may have contended this root mid-solve — committing
                # past that point would stream into state the batch
                # oracle would re-order
                if root in self._contended_roots or not self.armed:
                    continue
            wl = self.store.workloads.get(key)
            if wl is None or wl.is_quota_reserved or not wl.active:
                continue
            flavor = problem.cq_option_flavors[name][opt[w]]
            info = WorkloadInfo(wl, cluster_queue=name)
            flavor_of = {r: flavor for psr in info.total_requests
                         for r in psr.requests}
            declared = declared_of.get(name)
            if declared is None:
                declared = {
                    r for rg in
                    self.store.cluster_queues[name].resource_groups
                    for r in rg.covered_resources}
                declared_of[name] = declared
            usage: dict[tuple[str, str], int] = {}
            for psr in info.total_requests:
                for r, qty in psr.requests.items():
                    if r not in declared:
                        continue  # QuotaCheckStrategy=IgnoreUndeclared
                    fr = (flavor, r)
                    usage[fr] = usage.get(fr, 0) + qty
            self._commit_entry(wl, name, info, flavor_of, usage,
                               now, result)
            key_o = _order_key(info)
            prev = self._max_admitted.get(name)
            if prev is None or key_o > prev:
                self._max_admitted[name] = key_o
        for w in np.nonzero(parked[:W])[0]:
            key = problem.wl_keys[w]
            if not key:
                continue
            name = problem.cq_names[problem.wl_cqid[w]]
            root = root_of_batch.get(name)
            if root is None:
                continue
            with self._mu:
                if root in self._contended_roots or not self.armed:
                    continue
            q = self.queues.queues.get(name)
            if q is None:
                continue
            q.park(key)
            result.parked += 1
            obs.recorder.record(
                obs.SKIPPED, key, cycle=self._cycle(),
                cluster_queue=name, path=obs.STREAM,
                reason="parked inadmissible by the streaming fast "
                       "path: no flavor option fits at current "
                       "capacity",
                reason_slug="stream_parked")

    # -- wide-fence support: witness, headroom -----------------------------

    def _pick_stable(self, name: str, wl, cq_snap, snap,
                     assignment) -> bool:
        """The multi-flavor determinism witness: True when NO
        capacity event could make the batch oracle prefer an
        earlier-preference flavor over the pick just made — every
        earlier option is either statically incompatible (taint,
        selector, TAS shape, variant pin) or exceeds its static
        zero-usage capacity ceiling for some covered resource, so
        freeing capacity cannot surface it."""
        ceilings = self._flavor_ceilings.get(name) or {}
        ps = wl.podsets[0]
        checked: set[tuple[int, str]] = set()
        for psa in assignment.podsets:
            for res, rec in psa.flavors.items():
                rg = cq_snap.rg_by_resource(res)
                if rg is None:
                    return False
                if len(rg.flavors) <= 1:
                    continue
                mark = (id(rg), rec.name)
                if mark in checked:
                    continue
                checked.add(mark)
                order = [fq.name for fq in rg.flavors]
                try:
                    k = order.index(rec.name)
                except ValueError:
                    return False
                if k == 0:
                    continue
                allowed_keys = frozenset(
                    lk for fname in order
                    for lk in self._flavor_labels(snap, fname))
                covered = [(r, v) for r, v in psa.requests.items()
                           if r in rg.covered_resources]
                for g in order[:k]:
                    if (wl.allowed_flavor is not None
                            and g != wl.allowed_flavor):
                        continue  # variant-pinned away: static
                    flavor = snap.resource_flavors.get(g)
                    if flavor is None:
                        continue
                    if fa._untolerated_taint(ps, flavor) is not None:
                        continue
                    if not fa._selector_matches(ps, flavor,
                                                allowed_keys):
                        continue
                    if fa.tas_flavor_mismatch(
                            ps, flavor, cq_snap) is not None:
                        continue
                    # a compatible earlier option: the pick is stable
                    # only if the request tops the option's ceiling
                    # even on an empty hierarchy
                    if not any(v > ceilings.get((g, r), 0)
                               for r, v in covered):
                        return False
        return True

    @staticmethod
    def _flavor_labels(snap, fname: str):
        flavor = snap.resource_flavors.get(fname)
        return flavor.node_labels if flavor is not None else {}

    def _headroom_budget(self, name: str, cq_snap) -> dict:
        """The reserved nominal-headroom budget for one CQ, captured
        lazily from the window snapshot at first touch after the full
        solve (= the boundary's unused nominal) and drawn down by
        merged-walk commits. Mate commits never touch it: within-
        nominal usage lives on the CQ's own quota node."""
        budget = self._headroom.get(name)
        if budget is None:
            budget = {}
            spec = self.store.cluster_queues.get(name)
            if spec is not None:
                for rg in spec.resource_groups:
                    for fq in rg.flavors:
                        for rq in fq.resources:
                            fr = (fq.name, rq.name)
                            used = cq_snap.node.usage.get(fr, 0)
                            budget[fr] = max(0, rq.nominal - used)
            self._headroom[name] = budget
        return budget

    def _headroom_admits(self, name: str, assignment) -> bool:
        budget = self._headroom.get(name) or {}
        return all(v <= budget.get(fr, 0)
                   for fr, v in assignment.usage_quota.items())

    def _headroom_consume(self, name: str, assignment) -> None:
        budget = self._headroom.get(name)
        if budget is None:
            return
        for fr, v in assignment.usage_quota.items():
            budget[fr] = max(0, budget.get(fr, 0) - v)

    def _fence_event(self, key: str, cq: str, fence: str,
                     detail: Optional[dict] = None) -> None:
        """Flight-recorder trail: why a workload did not stream (which
        fence demoted it)."""
        d = {"fence": fence, "root": self._root_of.get(cq, f"cq:{cq}")}
        if detail:
            d.update(detail)
        obs.recorder.record(
            obs.SKIPPED, key, cycle=self._cycle(), cluster_queue=cq,
            path=obs.STREAM, reason=_FENCE_TEXT.get(fence, fence),
            reason_slug=f"stream_fence_{fence}", detail=d)

    def _note_structural(self, name: str, fence: str) -> None:
        """Record a structural (per-spec-generation) fence once per CQ
        against its current queue head."""
        if (name, fence) in self._fence_noted:
            return
        self._fence_noted.add((name, fence))
        q = self.queues.queues.get(name)
        if q is None or not q._in_heap:
            return
        head = min(q._in_heap.values(), key=_order_key)
        self._fence_event(head.key, name, fence)

    def _cycle(self) -> int:
        sched = self.engine.scheduler
        return (sched.cycle_count + 1 if sched is not None
                else self.engine.drain_count + 1)

    def _commit(self, wl, name: str, info: WorkloadInfo, assignment,
                now: float, result: MicroDrainResult) -> None:
        flavor_of: dict[str, str] = {}
        for psa in assignment.podsets:
            for r, rec in psa.flavors.items():
                flavor_of[r] = rec.name
        self._commit_entry(wl, name, info, flavor_of,
                           dict(assignment.usage_quota), now, result)

    def _commit_entry(self, wl, name: str, info: WorkloadInfo,
                      flavor_of: dict[str, str],
                      usage_quota: dict, now: float,
                      result: MicroDrainResult) -> None:
        """Engine commit shared by the host-walk (assignment-decoded)
        and micro-solve (plan-decoded) paths."""
        drain_result = _EngineResultAdapter()
        self.engine._drain_cycle = self._cycle()
        self.engine.last_drain_arm = "stream"
        self._committing_thread = threading.get_ident()
        try:
            self.engine._commit_admission(
                wl, name, flavor_of, info, now, drain_result)
        finally:
            self._committing_thread = None
        # keep the window snapshot current so the next entry's fit
        # check sees this admission's usage (the drain's in-round
        # usage refresh, host-side)
        cq_snap = self._snap.cluster_queue(name)
        if cq_snap is not None:
            cq_snap.add_usage(dict(usage_quota))
        result.admitted += drain_result.admitted
        result.admitted_keys.extend(drain_result.admitted_keys)
        self.count("stream_admitted_total", by=drain_result.admitted)

    def _record_ledger(self, result: MicroDrainResult) -> None:
        ledger = obs.cycle_ledger
        if not ledger.enabled:
            return
        phases = {"stream": round(result.duration_s, 6)}
        detail: dict = {"deferredCqs": result.deferred_cqs}
        if result.micro_batch:
            phases["micro_export"] = round(result.micro_export_s, 6)
            phases["micro_solve"] = round(result.micro_solve_s, 6)
            detail["microBatch"] = result.micro_batch
        ledger.record(
            self._cycle(), obs.STREAM_DRAIN,
            breaker=obs.breaker_state_name(),
            duration_s=result.duration_s,
            phases=phases,
            admitted=result.admitted, parked=result.parked,
            solver_arm="stream",
            detail=detail)

    def consume_full_solve_request(self) -> bool:
        """True at most once per spec-change fence: drain() observed a
        spec edit mid-window and the caller (the serve loop) should
        run the full cycle immediately instead of skipping it."""
        with self._mu:
            pending = self.full_solve_pending
            self.full_solve_pending = False
            return pending


def _can_borrow(spec) -> bool:
    """Whether any flavor quota of this CQ permits borrowing
    (borrowing_limit None = unlimited, the kueue default)."""
    for rg in spec.resource_groups:
        for fq in rg.flavors:
            for rq in fq.resources:
                if rq.borrowing_limit is None or rq.borrowing_limit > 0:
                    return True
    return False


class _EngineResultAdapter:
    """Duck-typed DrainResult stand-in for _commit_admission."""

    def __init__(self) -> None:
        self.admitted = 0
        self.admitted_keys: list[str] = []

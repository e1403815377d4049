"""Cycle ledger: one bounded structured record per scheduler cycle.

A copy of ``kueue_oss_tpu/obs/ledger.py``.

The flight recorder answers "why is THIS workload pending"; the ledger
answers "what did the CLUSTER do this cycle": one JSONL-dumpable row
per host scheduling cycle and per solver drain, keyed by the SAME
cycle id the recorder tags its DecisionEvents with — a ledger row and
the decision chain for a cycle join on that id (Gavel,
arXiv:2008.09213, treats per-round placement latencies as the primary
health artifact; this is our per-round record).

A host row carries the cycle's phase durations (the same phase names
the Tracer spans use — ``snapshot`` / ``nominate`` / ``entries`` /
``flush``), admitted/preempted/skipped counts with per-slug skip
breakdowns, and the solver breaker state at cycle end. A solver row
carries the chosen arm (host routing's third arm lives in the
scheduler), the session frame kind (sync/delta/legacy) with its
payload bytes and session churn stats, donated-buffer accounting
deltas from the resident device state, and the solve/apply walls.

Bounded ring (newest ``max_cycles`` rows), thread-safe, dumpable with
the same atomic + dir-fsynced discipline as the decision journal, and
persisted/restored alongside checkpoints by the PersistenceManager
(docs/DURABILITY.md).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from kueue_oss_tpu_torch import metrics

#: row kinds — one host row per scheduler cycle, one solver row per
#: engine drain (both tagged with the host cycle id the drain served),
#: one stream row per productive micro-batched admission drain
HOST_CYCLE = "host"
SOLVER_DRAIN = "solver"
STREAM_DRAIN = "stream"
#: degradation-ladder transition rows (resilience.DegradationController):
#: the transition entry rides in ``detail``; cycle-outcome fields stay 0
DEGRADATION_ROW = "degradation"


@dataclass
class CycleRecord:
    """One per-cycle (or per-drain) ledger row. Fields not meaningful
    for the row's kind stay at their zero values and are omitted from
    ``to_dict`` where empty."""

    seq: int
    ts: float
    cycle: int
    kind: str = HOST_CYCLE
    breaker: str = "closed"
    duration_s: float = 0.0
    #: phase name -> seconds (host rows: snapshot/nominate/entries/
    #: flush; solver rows: solve/apply)
    phases: dict = field(default_factory=dict)
    # -- host cycle outcome counts --------------------------------------
    heads: int = 0
    admitted: int = 0
    preempted: int = 0
    skipped: int = 0
    inadmissible: int = 0
    #: bounded reason slug -> count for this cycle's skips
    skip_slugs: dict = field(default_factory=dict)
    # -- solver drain routing + session wire ----------------------------
    solver_arm: str = ""            # "single" / "mesh" / "remote"
    rounds: int = 0
    parked: int = 0
    evicted: int = 0
    #: session frame kind: "delta" / "sync" / "legacy" (sessions off)
    frame_kind: str = ""
    #: payload bytes the frame shipped (delta rows+meta, or the full
    #: wire state for a sync)
    frame_bytes: int = 0
    #: why a full sync was forced ("" for deltas)
    frame_reason: str = ""
    #: HostDeltaSession churn stats (added/removed keys, dirty rows)
    session: dict = field(default_factory=dict)
    #: milliseconds this drain's solve request waited for its farm DRR
    #: grant (0 = dedicated sidecar / host path / farm idle)
    grant_wait_ms: float = 0.0
    #: resident-device accounting DELTAS for this drain: donated
    #: scatter bytes, avoided full-copy bytes, full uploads, donated
    #: full syncs (DeviceResidentProblem counters)
    device: dict = field(default_factory=dict)
    detail: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {"seq": self.seq, "ts": self.ts, "cycle": self.cycle,
             "kind": self.kind, "breaker": self.breaker,
             "durationS": self.duration_s}
        if self.phases:
            d["phases"] = self.phases
        if self.kind == HOST_CYCLE:
            d.update(heads=self.heads, admitted=self.admitted,
                     preempted=self.preempted, skipped=self.skipped,
                     inadmissible=self.inadmissible)
            if self.skip_slugs:
                d["skipSlugs"] = self.skip_slugs
        else:
            d.update(admitted=self.admitted, parked=self.parked,
                     evicted=self.evicted, rounds=self.rounds,
                     solverArm=self.solver_arm,
                     frameKind=self.frame_kind,
                     frameBytes=self.frame_bytes)
            if self.frame_reason:
                d["frameReason"] = self.frame_reason
            if self.session:
                d["session"] = self.session
            if self.grant_wait_ms:
                d["grantWaitMs"] = self.grant_wait_ms
            if self.device:
                d["device"] = self.device
        if self.detail:
            d["detail"] = self.detail
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CycleRecord":
        return cls(
            seq=int(d.get("seq", 0)), ts=float(d.get("ts", 0.0)),
            cycle=int(d.get("cycle", 0)),
            kind=str(d.get("kind", HOST_CYCLE)),
            breaker=str(d.get("breaker", "closed")),
            duration_s=float(d.get("durationS", 0.0)),
            phases=dict(d.get("phases") or {}),
            heads=int(d.get("heads", 0)),
            admitted=int(d.get("admitted", 0)),
            preempted=int(d.get("preempted", 0)),
            skipped=int(d.get("skipped", 0)),
            inadmissible=int(d.get("inadmissible", 0)),
            skip_slugs=dict(d.get("skipSlugs") or {}),
            solver_arm=str(d.get("solverArm", "")),
            rounds=int(d.get("rounds", 0)),
            parked=int(d.get("parked", 0)),
            evicted=int(d.get("evicted", 0)),
            frame_kind=str(d.get("frameKind", "")),
            frame_bytes=int(d.get("frameBytes", 0)),
            frame_reason=str(d.get("frameReason", "")),
            session=dict(d.get("session") or {}),
            grant_wait_ms=float(d.get("grantWaitMs", 0.0)),
            device=dict(d.get("device") or {}),
            detail=d.get("detail"))


class CycleLedger:
    """Bounded thread-safe ring of CycleRecords.

    ``record()`` is called once per scheduler cycle and once per solver
    drain — never per workload — so the steady-state cost is one
    dataclass and one deque append per cycle; ``enabled = False``
    reduces it to an attribute read (the bench twin's off arm).
    """

    def __init__(self, max_cycles: int = 4096, clock=time.time) -> None:
        self.enabled = True
        self.max_cycles = max_cycles
        self.clock = clock
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._ring: deque[CycleRecord] = deque(maxlen=max_cycles)

    # -- emission ----------------------------------------------------------

    def record(self, cycle: int, kind: str = HOST_CYCLE,
               **fields) -> Optional[CycleRecord]:
        if not self.enabled:
            return None
        row = CycleRecord(seq=next(self._seq), ts=self.clock(),
                          cycle=cycle, kind=kind, **fields)
        with self._lock:
            self._ring.append(row)
        metrics.ledger_records_total.inc(kind)
        if row.phases:
            # ledger-driven regression detection: every recorded row
            # feeds the per-(kind, phase) EWMA-vs-baseline detector
            # (obs/health.py; kueue_cycle_phase_regression)
            from kueue_oss_tpu_torch.obs.health import phase_regression

            phase_regression.feed(kind, row.phases)
        return row

    # -- queries -----------------------------------------------------------

    def rows(self, last: int = 0) -> list[CycleRecord]:
        """Ring snapshot, oldest-first (newest ``last`` rows if given)."""
        with self._lock:
            rows = list(self._ring)
        return rows[-last:] if last else rows

    def rows_for_cycle(self, cycle: int) -> list[CycleRecord]:
        """Every row tagged with this cycle id (one host row and, when
        a drain served the cycle, one solver row) — the join the
        recorder's decisions share."""
        return [r for r in self.rows() if r.cycle == cycle]

    def last_row(self, kind: Optional[str] = None
                 ) -> Optional[CycleRecord]:
        with self._lock:
            for r in reversed(self._ring):
                if kind is None or r.kind == kind:
                    return r
        return None

    # -- journal dump / load / restore -------------------------------------

    def dump_jsonl(self, path: str) -> int:
        """Atomic + dir-fsynced, the decision-journal discipline."""
        from kueue_oss_tpu_torch.obs import _atomic_write_jsonl

        rows = self.rows()
        _atomic_write_jsonl(path, (r.to_dict() for r in rows))
        return len(rows)

    def restore(self, rows: list[CycleRecord]) -> int:
        """Replace the ring with a persisted dump (recovery path); the
        seq counter continues past the restored rows so post-restart
        records keep a monotone journal order."""
        with self._lock:
            self._ring.clear()
            for r in rows[-self.max_cycles:]:
                self._ring.append(r)
            top = max((r.seq for r in self._ring), default=0)
            self._seq = itertools.count(top + 1)
        return len(self._ring)

    def resize(self, max_cycles: int) -> None:
        """Rebuild the ring at a new bound, keeping the newest rows
        (obs.configure applying ObservabilityConfig.ledger_max_cycles)."""
        with self._lock:
            self.max_cycles = max_cycles
            self._ring = deque(self._ring, maxlen=max_cycles)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


def load_ledger_jsonl(path: str) -> list[CycleRecord]:
    """Tolerant ledger-dump loader (torn/corrupt lines skipped with a
    counted warning — the decision journal's shared policy)."""
    from kueue_oss_tpu_torch.obs import _tolerant_load_jsonl

    out, skipped = _tolerant_load_jsonl(path, CycleRecord.from_dict,
                                        "ledger")
    load_ledger_jsonl.last_skipped = skipped
    return out


load_ledger_jsonl.last_skipped = 0


#: process-wide ledger (the obs.recorder idiom); tests clear() it
ledger = CycleLedger()

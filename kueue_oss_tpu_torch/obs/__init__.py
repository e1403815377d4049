"""Admission flight recorder: per-workload decision traces.

A copy of ``kueue_oss_tpu/obs/__init__.py``, with the ledger, the SLO
engine and device telemetry beside it (``obs/ledger.py``,
``obs/health.py``, ``obs/devtel.py``).

The hardest operational question for the reference Kueue is "why is my
job still pending?" — the answer is scattered across events, conditions
and logs, and the TPU solver path adds a second, opaque decision-maker.
This subsystem stitches the raw signals into an answer: a bounded,
thread-safe journal of one structured ``DecisionEvent`` per per-workload
outcome per cycle, tagged with the cycle id, the deciding path (host
cycle loop vs solver drain) and the solver breaker state at decision
time (Gavel, arXiv:2008.09213, and arXiv:2512.10980 both treat per-job
placement *reasons* as the primary debugging/fairness-audit artifact).

Surfaces:

- ``recorder.explain(key)`` — a workload's event history, newest-first
  (the dashboard's ``/api/workloads/<ns>/<name>/explain``);
- ``recorder.decisions(last_cycles=N)`` — the last N cycles' events
  (``/api/decisions``);
- ``recorder.dump_jsonl(path)`` / ``load_jsonl(path)`` — an offline
  journal for ``tools/explain.py``;
- every ``record()`` also bumps ``kueue_decision_events_total{kind}``
  and, for skips, ``kueue_decision_skips_total{reason}`` (the reason
  label is a bounded SLUG, never the free-form message).

The global ring keeps the newest ``max_events`` events (an operator
debugging a stall needs recent activity, not warm-up); a per-workload
side index keeps each workload's newest ``per_workload`` events even
after the ring has rotated past them, so ``explain`` stays useful for
long-pending workloads in a busy cluster.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

from kueue_oss_tpu_torch import metrics

logger = logging.getLogger(__name__)

# -- event kinds (the per-workload outcome vocabulary) ----------------------

NOMINATED = "nominated"          # entered the cycle; outcome still pending
ASSIGNED = "assigned"            # quota reserved by the host cycle
SKIPPED = "skipped"              # left the cycle unadmitted, with a reason
PREEMPTED = "preempted"          # evicted to make room for another workload
EVICTED = "evicted"              # evicted for a non-preemption reason
SOLVER_ADMITTED = "solver-admitted"  # quota reserved by the solver plan
SOLVER_FALLBACK = "solver-fallback"  # solver path degraded to the host path
DEGRADATION = "degradation"          # a degradation-ladder transition

KINDS = (NOMINATED, ASSIGNED, SKIPPED, PREEMPTED, EVICTED,
         SOLVER_ADMITTED, SOLVER_FALLBACK, DEGRADATION)

# -- decision paths ---------------------------------------------------------

HOST = "host"
SOLVER = "solver"
#: streaming micro-batched admission fast path (scheduler/streaming.py)
STREAM = "stream"

#: placeholder workload key for cycle-level events (e.g. a whole drain
#: degrading because the breaker is open) that belong to no one workload
CYCLE_SCOPE = "-"

_BREAKER_NAMES = {0.0: "closed", 1.0: "half-open", 2.0: "open"}


def breaker_state_name() -> str:
    """Current solver breaker state as a name, read from the gauge the
    resilience layer maintains (shared by the recorder's event tags and
    the dashboard's solver view — one mapping, not two)."""
    return _BREAKER_NAMES.get(
        metrics.solver_breaker_state.value(), "closed")


@dataclass
class DecisionEvent:
    """One per-workload outcome. ``reason`` is the human-readable
    explanation (the flavor assigner's no-fit message survives here
    verbatim); ``reason_slug`` is the bounded label used for the
    per-reason skip counters."""

    seq: int
    ts: float
    cycle: int
    kind: str
    workload: str
    cluster_queue: str = ""
    path: str = HOST
    reason: str = ""
    reason_slug: str = ""
    breaker: str = "closed"
    detail: Optional[dict] = field(default=None)

    def to_dict(self) -> dict:
        d = {
            "seq": self.seq, "ts": self.ts, "cycle": self.cycle,
            "kind": self.kind, "workload": self.workload,
            "clusterQueue": self.cluster_queue, "path": self.path,
            "reason": self.reason, "reasonSlug": self.reason_slug,
            "breaker": self.breaker,
        }
        if self.detail:
            d["detail"] = self.detail
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DecisionEvent":
        return cls(seq=int(d.get("seq", 0)), ts=float(d.get("ts", 0.0)),
                   cycle=int(d.get("cycle", 0)),
                   kind=str(d.get("kind", "")),
                   workload=str(d.get("workload", "")),
                   cluster_queue=str(d.get("clusterQueue", "")),
                   path=str(d.get("path", HOST)),
                   reason=str(d.get("reason", "")),
                   reason_slug=str(d.get("reasonSlug", "")),
                   breaker=str(d.get("breaker", "closed")),
                   detail=d.get("detail"))


class FlightRecorder:
    """Bounded, thread-safe decision journal.

    ``record()`` is called from the scheduler cycle, the solver apply
    path, and eviction flows — possibly from different threads (the
    serve loop vs controller callbacks), so every mutation holds the
    lock. Recording is cheap (one dataclass + two deque appends + a
    counter inc); ``enabled = False`` reduces it to one attribute read.
    """

    def __init__(self, max_events: int = 65_536, per_workload: int = 64,
                 max_workloads: int = 100_000,
                 clock=time.time) -> None:
        self.enabled = True
        self.max_events = max_events
        self.per_workload = per_workload
        self.max_workloads = max_workloads
        self.clock = clock
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._ring: deque[DecisionEvent] = deque(maxlen=max_events)
        #: workload key -> its newest events (LRU-bounded so a stream of
        #: one-shot workloads cannot grow the index without limit)
        self._by_workload: OrderedDict[str, deque] = OrderedDict()

    # -- emission ----------------------------------------------------------

    def record(self, kind: str, workload: str, *, cycle: int = 0,
               cluster_queue: str = "", path: str = HOST,
               reason: str = "", reason_slug: str = "",
               detail: Optional[dict] = None,
               breaker: Optional[str] = None) -> Optional[DecisionEvent]:
        """``breaker`` defaults to the LIVE breaker state; the journal
        replay layer passes the recorded value through so a replayed
        incident keeps its breaker tags."""
        if not self.enabled:
            return None
        if breaker is None:
            breaker = breaker_state_name()
        ev = DecisionEvent(
            seq=next(self._seq), ts=self.clock(), cycle=cycle, kind=kind,
            workload=workload, cluster_queue=cluster_queue, path=path,
            reason=reason, reason_slug=reason_slug, breaker=breaker,
            detail=detail)
        with self._lock:
            self._ring.append(ev)
            if workload != CYCLE_SCOPE:
                dq = self._by_workload.get(workload)
                if dq is None:
                    dq = deque(maxlen=self.per_workload)
                    self._by_workload[workload] = dq
                    if len(self._by_workload) > self.max_workloads:
                        self._by_workload.popitem(last=False)
                else:
                    self._by_workload.move_to_end(workload)
                dq.append(ev)
        metrics.decision_events_total.inc(kind)
        if kind in (SKIPPED, SOLVER_FALLBACK) and reason_slug:
            metrics.decision_skips_total.inc(reason_slug)
        return ev

    # -- queries -----------------------------------------------------------

    def explain(self, workload: str) -> list[DecisionEvent]:
        """The workload's event history, newest-first."""
        with self._lock:
            dq = self._by_workload.get(workload)
            return list(reversed(dq)) if dq else []

    def events(self) -> list[DecisionEvent]:
        """Ring snapshot, oldest-first."""
        with self._lock:
            return list(self._ring)

    def decisions(self, last_cycles: int = 10) -> list[dict]:
        """The last N distinct cycles' events, newest cycle first.

        Host and solver events sharing a cycle id land in the same
        group — the merged per-cycle view is the point."""
        with self._lock:
            snapshot = list(self._ring)
        groups: dict[int, list[DecisionEvent]] = {}
        for ev in snapshot:
            groups.setdefault(ev.cycle, []).append(ev)
        cycles = sorted(groups, reverse=True)[:max(0, last_cycles)]
        return [{"cycle": c,
                 "events": [ev.to_dict() for ev in groups[c]]}
                for c in cycles]

    # -- journal dump / load ----------------------------------------------

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(ev.to_dict())
                         for ev in self.events()) + "\n"

    def dump_jsonl(self, path: str) -> int:
        """Atomically write the journal: a crash mid-dump must never
        leave a half-written file where a previous complete journal
        stood (replay/simulation consume these dumps). The write goes
        to a same-directory temp file, lands via ``os.replace``, and
        the directory is fsynced too — an fsynced file behind an
        un-fsynced rename is not durable across power loss (the same
        discipline as the persist/ checkpoint writer)."""
        events = self.events()
        _atomic_write_jsonl(path, (ev.to_dict() for ev in events))
        return len(events)

    def restore(self, events: list[DecisionEvent]) -> int:
        """Replace the journal with a persisted dump (the recovery
        path, docs/DURABILITY.md): the ring, the per-workload index,
        and the seq counter all continue from the restored state so
        post-restart events keep a monotone journal order."""
        with self._lock:
            self._ring.clear()
            self._by_workload.clear()
            top = 0
            for ev in events[-self.max_events:]:
                self._ring.append(ev)
                top = max(top, ev.seq)
                if ev.workload == CYCLE_SCOPE:
                    continue
                dq = self._by_workload.get(ev.workload)
                if dq is None:
                    dq = deque(maxlen=self.per_workload)
                    self._by_workload[ev.workload] = dq
                    if len(self._by_workload) > self.max_workloads:
                        self._by_workload.popitem(last=False)
                else:
                    self._by_workload.move_to_end(ev.workload)
                dq.append(ev)
            self._seq = itertools.count(top + 1)
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_workload.clear()


def _atomic_write_jsonl(path: str, dicts) -> None:
    """Shared durable-JSONL writer: same-directory temp file, fsync,
    ``os.replace``, directory fsync (the checkpoint writer's
    discipline — used by both the decision journal and the ledger)."""
    from kueue_oss_tpu_torch.util.fsutil import fsync_dir

    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            for d in dicts:
                f.write(json.dumps(d) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(os.path.dirname(os.path.abspath(path)))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_jsonl(path: str) -> list[DecisionEvent]:
    """Load a journal dump written by ``dump_jsonl`` (tools/explain.py's
    and the sim replay layer's offline input).

    Blank lines are skipped. Torn or corrupt lines (a journal written
    by a pre-atomic dump that crashed mid-write, or one truncated in
    transit) are SKIPPED with one counted warning instead of raising:
    a damaged tail must not poison replay of the millions of intact
    events before it. The skip count of the MOST RECENT call is kept
    on the function as ``load_jsonl.last_skipped`` — best-effort
    module-level state (concurrent loads race on it); a diagnostic,
    not an API."""
    out, skipped = _tolerant_load_jsonl(path, DecisionEvent.from_dict,
                                        "journal")
    load_jsonl.last_skipped = skipped
    return out


load_jsonl.last_skipped = 0


def _tolerant_load_jsonl(path: str, parse, label: str
                         ) -> tuple[list, int]:
    """Shared tolerant JSONL reader (the decision journal's and the
    cycle ledger's one torn-line policy): blank lines skipped, corrupt
    lines skipped with one counted warning. Returns (rows, skipped)."""
    out = []
    skipped = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                if not isinstance(d, dict):
                    raise ValueError(f"{label} line is not an object")
                out.append(parse(d))
            except (ValueError, TypeError, KeyError):
                skipped += 1
                if skipped == 1:
                    logger.warning(
                        "%s %s: skipping corrupt line %d "
                        "(torn write?)", label, path, lineno)
    if skipped > 1:
        logger.warning("%s %s: skipped %d corrupt line(s) total",
                       label, path, skipped)
    return out, skipped


#: process-wide recorder (the metrics.registry idiom); tests swap or
#: clear() it via the autouse fixture
recorder = FlightRecorder()

# -- cluster health layer (ledger + SLO engine; imported AFTER the
# recorder exists — both modules may import this package lazily) ------------

from kueue_oss_tpu_torch.obs.health import (  # noqa: E402
    SLOEngine,
    oldest_pending,
)
from kueue_oss_tpu_torch.obs.health import slo as slo_engine  # noqa: E402
from kueue_oss_tpu_torch.obs.health import (  # noqa: E402
    WebhookSink,
    priority_class_of,
)
from kueue_oss_tpu_torch.obs.health import (  # noqa: E402
    phase_regression as phase_regression,
)
from kueue_oss_tpu_torch.obs.ledger import (  # noqa: E402
    DEGRADATION_ROW,
    HOST_CYCLE,
    SOLVER_DRAIN,
    STREAM_DRAIN,
    CycleLedger,
    CycleRecord,
    load_ledger_jsonl,
)
from kueue_oss_tpu_torch.obs.ledger import ledger as cycle_ledger  # noqa: E402
from kueue_oss_tpu_torch.obs import devtel  # noqa: E402
from kueue_oss_tpu_torch.obs.devtel import (  # noqa: E402
    CompileDetector,
    DeepCapture,
    DeviceTelemetry,
)
from kueue_oss_tpu_torch.obs.devtel import collector as device_telemetry  # noqa: E402


def configure(obs_cfg, capture_dir=None) -> None:
    """Apply a config.ObservabilityConfig to the process-wide obs
    state: the recorder/ledger switches and bounds, the metrics
    exemplar switch, the SLO engine's objectives (windows and alert
    state reset — a reconfigured objective starts clean), and the
    device-telemetry collector. ``capture_dir`` defaults devtel's
    deep-capture artifacts beside the checkpoints (callers pass
    ``cfg.persistence.dir``)."""
    recorder.enabled = obs_cfg.recorder_enabled
    cycle_ledger.enabled = obs_cfg.ledger_enabled
    if obs_cfg.ledger_max_cycles != cycle_ledger.max_cycles:
        cycle_ledger.resize(obs_cfg.ledger_max_cycles)
    metrics.exemplars_enabled = obs_cfg.exemplars
    s = obs_cfg.slo
    slo_engine.enabled = obs_cfg.slo_enabled
    slo_engine.reconfigure(
        target=s.queue_wait_target,
        threshold_s=s.queue_wait_threshold_seconds,
        fast_window_s=s.fast_window_seconds,
        slow_window_s=s.slow_window_seconds,
        burn_threshold=s.burn_rate_threshold,
        starvation_threshold_s=s.starvation_threshold_seconds)
    # alert sinks: a configured webhook replaces any previously
    # config-wired one (programmatic add_sink registrations persist)
    slo_engine.set_config_sink(
        WebhookSink(s.alert_webhook_url,
                    timeout_s=s.alert_webhook_timeout_seconds)
        if s.alert_webhook_url else None)
    devtel.collector.configure(obs_cfg.devtel, capture_dir=capture_dir)

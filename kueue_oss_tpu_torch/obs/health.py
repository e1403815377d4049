"""Queue-wait SLO engine: burn-rate alerts + starvation watchdog.

A copy of ``kueue_oss_tpu/obs/health.py``.

The SLI is **time-to-admit**: the seconds between a workload's creation
and its quota reservation, observed once per admission on both the host
cycle path and the solver drain path (the same wait
``metrics.admitted_workload`` feeds into the wait-time histograms).
An admission is *good* when its wait is within the objective's
threshold; the error budget is ``1 - target``.

Alerting is the classic multi-window burn-rate scheme: the burn rate is
``bad_fraction / error_budget`` over a window, and an alert fires only
when BOTH the fast window (default 5m — catches a live regression) and
the slow window (default 1h — suppresses blips) burn above the
threshold; it clears when the fast window recovers. Every piece of
time is injectable (``clock=`` / ``now=``), so tests drive
deterministic fire/clear sequences on a virtual clock.

The starvation watchdog is the fairness backstop the windows cannot
see: an empty-window CQ with a decade-old pending head has a zero burn
rate but is maximally unhealthy (arXiv:2512.10980 treats oldest-pending
age as the first-class starvation signal). ``evaluate(queues=...)``
surfaces the oldest pending age per CQ against its own threshold.

Each bad admission keeps an exemplar ({cycle, workload, wait}) — the
same exemplar the wait-time histogram's bucket carries — so a firing
alert links straight to the cycle's ledger row and the workload's
decision chain (the acceptance contract in docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Optional

from kueue_oss_tpu_torch import metrics

#: SLI scopes — per-ClusterQueue and per-priority-class series (the
#: priority scope keys on WorkloadPriorityClass NAMES when the
#: workload carries one, falling back to the stringified integer —
#: /api/slo groups by class, not by raw integer)
SCOPE_CQ = "cq"
SCOPE_PRIORITY = "priority"

FIRING = "firing"
CLEAR = "clear"


def priority_class_of(store, wl) -> str:
    """The SLI key for a workload's priority: its declared
    WorkloadPriorityClass name, else the name of a class whose value
    matches the raw integer, else the stringified integer. One
    mapping shared by the host admit path and the solver commit. The
    port's Workload and Store carry no priority classes (cut from the
    API copy), so there the key is the stringified integer, what the
    JAX function gives for a store without classes."""
    if getattr(wl, "priority_class", None):
        return str(wl.priority_class)
    for name, pc in (getattr(store, "priority_classes", None)
                     or {}).items():
        if pc.value == wl.priority:
            return name
    return str(wl.priority)


class _WindowSeries:
    """Time-bucketed good/bad admission counts covering the slow
    window. Fixed-size ring of buckets; a bucket is lazily reset when
    its wall slot is reused, so feeding and summing are O(1)/O(ring)
    with no timers."""

    def __init__(self, bucket_s: float, n_buckets: int) -> None:
        self.bucket_s = bucket_s
        self.n = n_buckets
        self._epoch = [-1] * n_buckets
        self._total = [0] * n_buckets
        self._bad = [0] * n_buckets

    def _slot(self, t: float) -> tuple[int, int]:
        epoch = int(t // self.bucket_s)
        return epoch, epoch % self.n

    def add(self, t: float, good: bool) -> None:
        epoch, slot = self._slot(t)
        if self._epoch[slot] != epoch:
            self._epoch[slot] = epoch
            self._total[slot] = 0
            self._bad[slot] = 0
        self._total[slot] += 1
        if not good:
            self._bad[slot] += 1

    def sums(self, now: float, window_s: float) -> tuple[int, int]:
        """(total, bad) over the trailing window ending at ``now``."""
        newest = int(now // self.bucket_s)
        oldest = int((now - window_s) // self.bucket_s) + 1
        total = bad = 0
        for slot in range(self.n):
            e = self._epoch[slot]
            if oldest <= e <= newest:
                total += self._total[slot]
                bad += self._bad[slot]
        return total, bad


@dataclass
class Alert:
    scope: str
    key: str
    state: str = CLEAR
    since: float = 0.0
    burn_fast: float = 0.0
    burn_slow: float = 0.0
    #: {cycle, workload, waitSeconds} of the newest breaching
    #: admission — the link into the ledger row + explain chain
    exemplar: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {"scope": self.scope, "key": self.key, "state": self.state,
             "since": self.since,
             "burnFast": round(self.burn_fast, 3),
             "burnSlow": round(self.burn_slow, 3)}
        if self.exemplar:
            d["exemplar"] = self.exemplar
        return d


class SLOEngine:
    """Per-CQ and per-priority queue-wait SLIs with multi-window
    burn-rate alerts. Feeding (``observe_admission``) is O(1) and
    lock-held; evaluation walks every known key once."""

    def __init__(self, *, target: float = 0.99,
                 threshold_s: float = 300.0,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 burn_threshold: float = 6.0,
                 starvation_threshold_s: float = 1800.0,
                 clock=time.time) -> None:
        self.enabled = True
        self.target = target
        self.threshold_s = threshold_s
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.burn_threshold = burn_threshold
        self.starvation_threshold_s = starvation_threshold_s
        self.clock = clock
        #: newest instant this engine has been told about (feeds and
        #: scheduler advance() calls). The scheduler drives the whole
        #: system on a caller-supplied logical clock (virtual in tests
        #: and benches, time.monotonic in serve()), so evaluate()
        #: must default to the FEED domain's newest instant — walling
        #: it to time.time() would put every fed bucket outside the
        #: windows and read burn 0 forever.
        self._now = 0.0
        self._set_geometry(fast_window_s, slow_window_s)
        self._lock = threading.Lock()
        #: serializes whole evaluations: two dashboard threads hitting
        #: /api/slo and /api/health at once must not race the alert
        #: state machine into double fired/cleared transitions
        self._eval_lock = threading.Lock()
        self._series: dict[tuple[str, str], _WindowSeries] = {}
        #: newest breaching admission per key (alert exemplars)
        self._breach: dict[tuple[str, str], dict] = {}
        self.alerts: dict[tuple[str, str], Alert] = {}
        #: last starvation snapshot (evaluate(queues=...))
        self._starvation: list[dict] = []
        #: pluggable alert sinks: callables invoked as
        #: ``sink(transition, alert_dict)`` on every fire/clear
        #: transition. Failures are counted
        #: (kueue_slo_alert_deliveries_total{outcome}) and never
        #: break evaluation. ``_config_sink`` is the slot
        #: obs.configure() owns (a webhook from SLOConfig); add_sink
        #: registrations are programmatic and survive reconfigures.
        self.sinks: list = []
        self._config_sink = None

    def _set_geometry(self, fast_window_s: float,
                      slow_window_s: float) -> None:
        #: bucket width: 1/30 of the fast window (>= 1s) keeps the fast
        #: window's edge error under ~3%
        self._bucket_s = max(1.0, fast_window_s / 30.0)
        self._n_buckets = int(math.ceil(slow_window_s
                                        / self._bucket_s)) + 2

    def reconfigure(self, *, target: float, threshold_s: float,
                    fast_window_s: float, slow_window_s: float,
                    burn_threshold: float,
                    starvation_threshold_s: float) -> None:
        """Apply new objectives and rebuild the window geometry; the
        window and alert state start clean (a reconfigured objective
        must not inherit burn computed against the old one)."""
        self.target = target
        self.threshold_s = threshold_s
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.burn_threshold = burn_threshold
        self.starvation_threshold_s = starvation_threshold_s
        self._set_geometry(fast_window_s, slow_window_s)
        self.reset()

    @classmethod
    def from_config(cls, cfg, clock=time.time) -> "SLOEngine":
        """Build from config.SLOConfig."""
        return cls(target=cfg.queue_wait_target,
                   threshold_s=cfg.queue_wait_threshold_seconds,
                   fast_window_s=cfg.fast_window_seconds,
                   slow_window_s=cfg.slow_window_seconds,
                   burn_threshold=cfg.burn_rate_threshold,
                   starvation_threshold_s=(
                       cfg.starvation_threshold_seconds),
                   clock=clock)

    # -- feeding -----------------------------------------------------------

    def observe_admission(self, cq: str, wait_s: float, *,
                          priority: int = 0, priority_class: str = "",
                          now: Optional[float] = None,
                          cycle: int = 0, workload: str = "") -> None:
        """One admitted workload's time-to-admit, fed at the same call
        sites as ``metrics.admitted_workload`` (scheduler._admit and
        the solver engine's commit). ``priority_class`` keys the
        priority-scope SLI by WorkloadPriorityClass name
        (priority_class_of); blank falls back to the raw integer."""
        if not self.enabled:
            return
        t = now if now is not None else self.clock()
        if t > self._now:
            self._now = t
        good = wait_s <= self.threshold_s
        pkey = priority_class or str(priority)
        with self._lock:
            for key in ((SCOPE_CQ, cq), (SCOPE_PRIORITY, pkey)):
                s = self._series.get(key)
                if s is None:
                    s = self._series[key] = _WindowSeries(
                        self._bucket_s, self._n_buckets)
                s.add(t, good)
                if not good:
                    self._breach[key] = {
                        "cycle": cycle, "workload": workload,
                        "waitSeconds": round(float(wait_s), 3)}

    def replay_journal(self, events) -> int:
        """Rebuild the SLI windows from a restored decision journal
        (the SLO engine's window state dies with the process; the
        durable journal carries each admission's wait in its detail —
        docs/DURABILITY.md recovery path). Returns admissions replayed."""
        from kueue_oss_tpu_torch import obs

        n = 0
        for ev in events:
            if ev.kind not in (obs.ASSIGNED, obs.SOLVER_ADMITTED):
                continue
            detail = ev.detail or {}
            if "waitSeconds" not in detail:
                continue
            self.observe_admission(
                ev.cluster_queue, float(detail["waitSeconds"]),
                priority=int(detail.get("priority", 0)),
                priority_class=str(detail.get("priorityClass", "")),
                now=ev.ts, cycle=ev.cycle, workload=ev.workload)
            n += 1
        return n

    def advance(self, now: float) -> None:
        """Advance the engine's logical clock (the scheduler calls
        this each cycle, including empty ones): windows roll and
        alerts can clear even when no admissions arrive."""
        if self.enabled and now > self._now:
            self._now = now

    # -- evaluation --------------------------------------------------------

    def _burn(self, total: int, bad: int) -> float:
        if total == 0:
            return 0.0
        budget = max(1e-9, 1.0 - self.target)
        return (bad / total) / budget

    def evaluate(self, now: Optional[float] = None,
                 queues=None) -> dict:
        """Walk every SLI key, update alert states + gauges, and (with
        ``queues``) refresh the starvation watchdog. Returns the
        /api/slo report."""
        with self._eval_lock:
            return self._evaluate(now, queues)

    def _evaluate(self, now: Optional[float], queues) -> dict:
        # default to the feed domain's newest instant — the dashboard
        # threads don't know the caller's clock; self.clock is only
        # the fallback before anything has been fed or advanced
        t = now if now is not None else (self._now or self.clock())
        slis = []
        with self._lock:
            keys = list(self._series.items())
            breach = dict(self._breach)
        for key, series in keys:
            scope, name = key
            # sum under the feed lock: add() writes _epoch[slot] before
            # zeroing the counts, so a lock-free sums() could pair a
            # current epoch with a stale bucket's tallies
            with self._lock:
                ft, fb = series.sums(t, self.fast_window_s)
                st, sb = series.sums(t, self.slow_window_s)
            burn_fast, burn_slow = self._burn(ft, fb), self._burn(st, sb)
            alert = self.alerts.get(key)
            if alert is None:
                alert = self.alerts[key] = Alert(scope=scope, key=name)
            alert.burn_fast, alert.burn_slow = burn_fast, burn_slow
            should_fire = (burn_fast > self.burn_threshold
                           and burn_slow > self.burn_threshold)
            recovered = burn_fast <= self.burn_threshold
            if alert.state != FIRING and should_fire:
                alert.state, alert.since = FIRING, t
                alert.exemplar = breach.get(key)
                metrics.slo_alert_transitions_total.inc(
                    scope, name, "fired")
                self._notify("fired", alert)
            elif alert.state == FIRING and recovered:
                alert.state, alert.since = CLEAR, t
                metrics.slo_alert_transitions_total.inc(
                    scope, name, "cleared")
                self._notify("cleared", alert)
            elif alert.state == FIRING:
                # keep the exemplar pointing at the newest breach while
                # the alert stays up
                alert.exemplar = breach.get(key, alert.exemplar)
            metrics.slo_burn_rate.set(scope, name, "fast",
                                      value=burn_fast)
            metrics.slo_burn_rate.set(scope, name, "slow",
                                      value=burn_slow)
            metrics.slo_alerts_firing.set(
                scope, name, value=1.0 if alert.state == FIRING else 0.0)
            slis.append({
                "scope": scope, "key": name,
                "fast": {"total": ft, "bad": fb},
                "slow": {"total": st, "bad": sb},
                "burnFast": round(burn_fast, 3),
                "burnSlow": round(burn_slow, 3),
                "alert": alert.to_dict(),
            })
        if queues is not None:
            self._starvation = self._watch_starvation(t, queues)
        return {
            "objective": self.objective(),
            "evaluatedAt": t,
            "slis": slis,
            "alerts": [a.to_dict() for a in self.alerts.values()
                       if a.state == FIRING],
            "starvation": list(self._starvation),
        }

    def objective(self) -> dict:
        return {"target": self.target,
                "thresholdSeconds": self.threshold_s,
                "fastWindowSeconds": self.fast_window_s,
                "slowWindowSeconds": self.slow_window_s,
                "burnRateThreshold": self.burn_threshold,
                "starvationThresholdSeconds": (
                    self.starvation_threshold_s)}

    def firing(self) -> list[Alert]:
        return [a for a in self.alerts.values() if a.state == FIRING]

    # -- alert sinks -------------------------------------------------------

    def add_sink(self, sink) -> None:
        """Register ``sink(transition, alert_dict)`` for fire/clear
        notifications (transition in {"fired", "cleared"})."""
        self.sinks.append(sink)

    def remove_sink(self, sink) -> None:
        if sink in self.sinks:
            self.sinks.remove(sink)

    def set_config_sink(self, sink) -> None:
        """The one config-owned sink slot (obs.configure); replacing
        or clearing it never touches programmatic registrations."""
        self._config_sink = sink

    def _notify(self, transition: str, alert: Alert) -> None:
        """Deliver one transition to every sink. Delivery runs inline
        with evaluation (transitions are rare by construction); a
        failing sink is counted, never raised — alerting must not be
        able to break the scheduler or the dashboard."""
        sinks = list(self.sinks)
        if self._config_sink is not None:
            sinks.append(self._config_sink)
        if not sinks:
            return
        payload = alert.to_dict()
        payload["transition"] = transition
        for sink in sinks:
            try:
                sink(transition, dict(payload))
                metrics.slo_alert_deliveries_total.inc("ok")
            except Exception:
                metrics.slo_alert_deliveries_total.inc("error")

    def _watch_starvation(self, now: float, queues) -> list[dict]:
        """Oldest pending age per CQ (heap + parked), newest snapshot.
        O(pending) — evaluation-time only, never per cycle."""
        out = []
        ages: dict[tuple, float] = {}
        for name, age, key in oldest_pending(queues, now):
            ages[(name,)] = age
            out.append({"clusterQueue": name,
                        "oldestAgeSeconds": round(age, 3),
                        "workload": key,
                        "starved": age > self.starvation_threshold_s})
        # replace_prefix, not per-key set: a CQ whose backlog drained
        # must report 0 once and then drop, not stay frozen at its
        # last starved age forever
        metrics.starvation_oldest_pending_seconds.replace_prefix(
            (), ages)
        out.sort(key=lambda d: -d["oldestAgeSeconds"])
        return out

    def reset(self) -> None:
        """Test helper: drop windows, alerts, and starvation state."""
        with self._lock:
            self._series.clear()
            self._breach.clear()
        self.alerts.clear()
        self._starvation = []
        self._now = 0.0


def oldest_pending(queues, now: float) -> list[tuple[str, float, str]]:
    """(cq, oldest pending age, workload key) for every CQ with any
    pending (heap or parked-inadmissible) workload. Walks the queue
    dicts under the QueueManager's mutex — evaluation runs on
    dashboard HTTP threads while the scheduler thread mutates them."""
    import contextlib

    mu = getattr(queues, "_mu", None)
    out = []
    with mu if mu is not None else contextlib.nullcontext():
        for name, q in queues.queues.items():
            oldest_t, oldest_key = None, ""
            for infos in (q._in_heap.values(), q.inadmissible.values()):
                for info in infos:
                    ct = info.obj.creation_time
                    if oldest_t is None or ct < oldest_t:
                        oldest_t, oldest_key = ct, info.key
            if oldest_t is not None:
                out.append((name, max(0.0, now - oldest_t), oldest_key))
    return out


class WebhookSink:
    """POSTs each fire/clear transition as JSON to a webhook URL.

    Delivery failures raise (the engine's _notify counts them under
    kueue_slo_alert_deliveries_total{outcome="error"}); the short
    timeout bounds how long a dead receiver can stall an evaluation.
    """

    def __init__(self, url: str, timeout_s: float = 2.0) -> None:
        self.url = url
        self.timeout_s = timeout_s

    def __call__(self, transition: str, payload: dict) -> None:
        import json
        import urllib.request

        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            r.read()


class PhaseRegressionDetector:
    """Ledger-driven regression detection over per-cycle phase walls.

    Every CycleLedger row's ``phases`` dict feeds a per-(kind, phase)
    pair of EWMAs: a slow baseline (what this phase normally costs)
    and a fast tracker (what it costs right now). After a warm-up
    sample count, ``fast > ratio * baseline`` flags the phase as
    regressing — surfaced as kueue_cycle_phase_regression{kind,phase}
    and a ``health`` signal in /api/health. The baseline keeps
    adapting slowly, so a permanent plan change (bigger store, new
    hardware) re-baselines instead of alerting forever; a sudden 2x+
    jump (lock contention, a pathological snapshot, GC storms) fires
    within a handful of cycles.
    """

    def __init__(self, *, ratio: float = 2.0, min_samples: int = 20,
                 fast_alpha: float = 0.3,
                 slow_alpha: float = 0.02) -> None:
        self.enabled = True
        self.ratio = ratio
        self.min_samples = min_samples
        self.fast_alpha = fast_alpha
        self.slow_alpha = slow_alpha
        self._lock = threading.Lock()
        #: (kind, phase) -> [fast_ewma, slow_ewma, samples, regressing]
        self._state: dict[tuple[str, str], list] = {}

    def feed(self, kind: str, phases: dict) -> None:
        if not self.enabled or not phases:
            return
        with self._lock:
            for phase, wall in phases.items():
                try:
                    w = float(wall)
                except (TypeError, ValueError):
                    continue
                st = self._state.get((kind, phase))
                if st is None:
                    st = self._state[(kind, phase)] = [w, w, 0, False]
                st[0] += self.fast_alpha * (w - st[0])
                st[1] += self.slow_alpha * (w - st[1])
                st[2] += 1
                ratio = st[0] / st[1] if st[1] > 0 else 1.0
                was = st[3]
                st[3] = (st[2] >= self.min_samples
                         and ratio > self.ratio)
                metrics.cycle_phase_regression_ratio.set(
                    kind, phase, value=ratio)
                if st[3] != was:
                    metrics.cycle_phase_regression.set(
                        kind, phase, value=1.0 if st[3] else 0.0)

    def regressing(self) -> list[dict]:
        """Currently regressing phases (the /api/health signal)."""
        with self._lock:
            return [{"kind": k, "phase": p,
                     "fastSeconds": round(st[0], 6),
                     "baselineSeconds": round(st[1], 6),
                     "ratio": round(st[0] / st[1], 3) if st[1] > 0
                     else 1.0}
                    for (k, p), st in self._state.items() if st[3]]

    def reset(self) -> None:
        with self._lock:
            self._state.clear()


#: process-wide engine (the obs.recorder idiom); obs.configure() swaps
#: its objectives in from an ObservabilityConfig
slo = SLOEngine()

#: process-wide phase-regression detector, fed by CycleLedger.record
phase_regression = PhaseRegressionDetector()

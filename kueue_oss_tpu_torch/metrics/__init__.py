"""Prometheus-style metrics registry.

A copy of ``kueue_oss_tpu/metrics/__init__.py``: every series under its
JAX name and labels, so the port's ``render()`` reads like the JAX
package's.

Reference parity: pkg/metrics/metrics.go:316-857 — the same series names and
label sets, backed by a small in-process registry instead of the Prometheus
client. `render()` emits text exposition format for scraping/inspection, and
the perf runner scrapes counters the same way the reference's runner scrapes
minimalkueue's metrics endpoint.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Iterable, Optional

# Default histogram buckets mirroring prometheus.DefBuckets plus the
# exponential range the reference uses for wait-time series.
DEF_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
WAIT_BUCKETS = tuple(1 * 2 ** i for i in range(15))  # 1s .. ~4.5h

LabelValues = tuple[str, ...]

#: process-wide exemplar switch (obs.configure / bench twins): with it
#: off, Histogram.observe drops exemplar payloads before taking the
#: lock, so the disabled cost is one module-attribute read
exemplars_enabled = True


class _Series:
    def __init__(self, name: str, help_: str, labels: tuple[str, ...]) -> None:
        self.name = name
        self.help = help_
        self.labels = labels
        self._lock = threading.Lock()

    def _key(self, label_values: Iterable[str]) -> LabelValues:
        key = tuple(str(v) for v in label_values)
        if len(key) != len(self.labels):
            raise ValueError(
                f"{self.name}: expected labels {self.labels}, got {key}")
        return key


class Counter(_Series):
    kind = "counter"

    def __init__(self, name: str, help_: str,
                 labels: tuple[str, ...] = ()) -> None:
        super().__init__(name, help_, labels)
        self._values: dict[LabelValues, float] = {}

    def inc(self, *label_values: str, by: float = 1.0) -> None:
        key = self._key(label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def value(self, *label_values: str) -> float:
        return self._values.get(self._key(label_values), 0.0)

    def total(self) -> float:
        return sum(self._values.values())

    def delete_matching(self, **by_label: str) -> None:
        idx = {self.labels.index(k): v for k, v in by_label.items()}
        with self._lock:
            for key in [k for k in self._values
                        if all(k[i] == v for i, v in idx.items())]:
                del self._values[key]

    def collect(self) -> dict[LabelValues, float]:
        # a concurrent inc()/set() during a scrape would otherwise raise
        # "dictionary changed size during iteration" inside dict()
        with self._lock:
            return dict(self._values)


class Gauge(Counter):
    kind = "gauge"

    def set(self, *label_values: str, value: float) -> None:
        key = self._key(label_values)
        with self._lock:
            self._values[key] = float(value)

    def replace_prefix(self, prefix: tuple[str, ...],
                       updates: dict[tuple, float]) -> None:
        """Set every (prefix + suffix) sample from `updates`; stale
        samples sharing the prefix first report one scrape of 0, then
        drop off entirely — a drained gauge must not keep its last
        value, and churned label sets must not accumulate forever
        (reference metrics.go zero-fill + DeleteLabelValues)."""
        n = len(prefix)
        with self._lock:
            for key in list(self._values):
                if key[:n] == prefix and key[n:] not in updates:
                    if self._values[key] == 0.0:
                        del self._values[key]
                    else:
                        self._values[key] = 0.0
        for suffix, v in updates.items():
            self.set(*(prefix + tuple(suffix)), value=v)


class Histogram(_Series):
    kind = "histogram"

    def __init__(self, name: str, help_: str, labels: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = DEF_BUCKETS) -> None:
        super().__init__(name, help_, labels)
        self.buckets = tuple(sorted(buckets))
        #: key -> (bucket counts, sum, count)
        self._values: dict[LabelValues, tuple[list[int], float, int]] = {}
        #: key -> bucket index -> (exemplar labels, value, optional ts);
        #: index len(buckets) is the +Inf bucket. One exemplar per
        #: bucket (the newest), the OpenMetrics convention — it links a
        #: latency bucket back to the exact decision (cycle/workload)
        #: that landed there.
        self._exemplars: dict[
            LabelValues, dict[int, tuple[dict, float, float]]] = {}

    def observe(self, *label_values: str, value: float,
                exemplar: Optional[dict] = None,
                exemplar_ts: Optional[float] = None) -> None:
        """``exemplar`` is a small {label: value} dict (e.g.
        {"cycle": 17, "workload": "ns/w"}) attached to the bucket this
        observation falls in and emitted in the OpenMetrics
        exposition; ignored while ``exemplars_enabled`` is False.
        Stored as given — values stringify at render/accessor time, so
        the admission hot path pays one tuple store, not a dict
        rebuild (the bench.py slo scenario's exemplar_overhead_pct
        twin measures exactly this path)."""
        key = self._key(label_values)
        if exemplar is not None and not exemplars_enabled:
            exemplar = None
        with self._lock:
            counts, total, n = self._values.get(
                key, ([0] * len(self.buckets), 0.0, 0))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._values[key] = (counts, total + value, n + 1)
            if exemplar is not None:
                # first bucket with edge >= value == the le bucket the
                # observation lands in (len(buckets) == +Inf); the
                # timestamp is optional in the OpenMetrics grammar, so
                # the hot path never calls time.time() itself
                idx = bisect_left(self.buckets, value)
                self._exemplars.setdefault(key, {})[idx] = (
                    exemplar, float(value), exemplar_ts)

    def count(self, *label_values: str) -> int:
        # reads hold the lock too: observe() replaces the value tuple,
        # and a torn (counts, sum, n) read would hand the caller a sum
        # from one generation and a count from another
        key = self._key(label_values)
        with self._lock:
            v = self._values.get(key)
            return v[2] if v else 0

    def sum(self, *label_values: str) -> float:
        key = self._key(label_values)
        with self._lock:
            v = self._values.get(key)
            return v[1] if v else 0.0

    def total_count(self) -> int:
        with self._lock:
            return sum(v[2] for v in self._values.values())

    def exemplars(self, *label_values: str
                  ) -> dict[int, tuple[dict, float, Optional[float]]]:
        """Bucket index -> (labels, value, ts) snapshot for one key,
        label values stringified (the exposition's view)."""
        key = self._key(label_values)
        with self._lock:
            raw = dict(self._exemplars.get(key, {}))
        return {i: ({str(k): str(v) for k, v in labels.items()},
                    value, ts)
                for i, (labels, value, ts) in raw.items()}

    def delete_matching(self, **by_label: str) -> None:
        idx = {self.labels.index(k): v for k, v in by_label.items()}
        with self._lock:
            for key in [k for k in self._values
                        if all(k[i] == v for i, v in idx.items())]:
                del self._values[key]
                self._exemplars.pop(key, None)

    def collect(self):
        # copy the per-key bucket lists too: observe() mutates them in
        # place, so a shallow dict copy would still hand the renderer a
        # list another thread is updating mid-iteration
        with self._lock:
            return {k: (list(counts), total, n)
                    for k, (counts, total, n) in self._values.items()}

    def collect_exemplars(self):
        with self._lock:
            return {k: dict(v) for k, v in self._exemplars.items()}


class Registry:
    def __init__(self) -> None:
        self._series: dict[str, _Series] = {}
        # register()/get() race the exposition path (a scrape iterating
        # the series dict while a late import registers a new one);
        # all three now share this lock
        self._lock = threading.Lock()

    def register(self, s: _Series) -> _Series:
        with self._lock:
            self._series[s.name] = s
        return s

    def get(self, name: str) -> Optional[_Series]:
        with self._lock:
            return self._series.get(name)

    def _series_snapshot(self) -> list[_Series]:
        with self._lock:
            return list(self._series.values())

    def render(self, openmetrics: bool = False) -> str:
        """Text exposition: Prometheus 0.0.4 by default, OpenMetrics
        with ``openmetrics=True`` — same series, plus per-bucket
        exemplars (``# {labels} value ts``) and the ``# EOF``
        terminator. Exemplars only exist in the OpenMetrics form; the
        classic format has no grammar for them."""
        out: list[str] = []
        for s in self._series_snapshot():
            family = s.name
            if (openmetrics and s.kind == "counter"
                    and family.endswith("_total")):
                # the OpenMetrics grammar names a counter FAMILY
                # suffix-free and requires its sample to be
                # <family>_total; emitting both with the suffix makes
                # a real Prometheus scrape fail to parse
                family = family[:-len("_total")]
            out.append(f"# HELP {family} {_escape_help(s.help)}")
            out.append(f"# TYPE {family} {s.kind}")
            if isinstance(s, Histogram):
                ex_of = s.collect_exemplars() if openmetrics else {}
                for key, (counts, total, n) in sorted(s.collect().items()):
                    base = _fmt_labels(s.labels, key)
                    exemplars = ex_of.get(key, {})
                    for i, (b, c) in enumerate(zip(s.buckets, counts)):
                        le = _merge_labels(base, f'le="{b}"')
                        out.append(f"{s.name}_bucket{le} {c}"
                                   + _fmt_exemplar(exemplars.get(i)))
                    inf = _merge_labels(base, 'le="+Inf"')
                    out.append(f"{s.name}_bucket{inf} {n}"
                               + _fmt_exemplar(
                                   exemplars.get(len(s.buckets))))
                    out.append(f"{s.name}_sum{base} {total}")
                    out.append(f"{s.name}_count{base} {n}")
            else:
                for key, v in sorted(s.collect().items()):  # type: ignore[attr-defined]
                    out.append(f"{s.name}{_fmt_labels(s.labels, key)} {v}")
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"


def _escape_label_value(v: str) -> str:
    """Prometheus/OpenMetrics label-value escaping: backslash, double
    quote, newline. Recorder reason strings and CQ names flow into
    labels verbatim — an unescaped quote or newline would corrupt the
    whole exposition for every scraper."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    # HELP lines escape backslash and newline only (the exposition
    # grammar; quotes are legal there)
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(names: tuple[str, ...], values: LabelValues) -> str:
    if not names:
        return ""
    pairs = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in zip(names, values))
    return "{" + pairs + "}"


def _fmt_exemplar(ex: Optional[tuple[dict, float, Optional[float]]]) -> str:
    if ex is None:
        return ""
    labels, value, ts = ex
    pairs = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    tail = f" {round(ts, 3)}" if ts is not None else ""
    return " # {" + pairs + "} " + f"{value}" + tail


def _merge_labels(base: str, extra: str) -> str:
    if not base:
        return "{" + extra + "}"
    return base[:-1] + "," + extra + "}"


registry = Registry()

# -- scheduler cycle (metrics.go:316-347) -----------------------------------

admission_attempts_total = registry.register(Counter(
    "kueue_admission_attempts_total",
    "Total number of admission cycle attempts by result", ("result",)))
admission_attempt_duration_seconds = registry.register(Histogram(
    "kueue_admission_attempt_duration_seconds",
    "Latency of an admission cycle attempt", ("result",)))
admission_cycle_preemption_skips = registry.register(Gauge(
    "kueue_admission_cycle_preemption_skips",
    "Workloads skipped by preemption in the last cycle", ("cluster_queue",)))

# -- pending / status gauges (metrics.go:360-382, 677-732) -------------------

pending_workloads = registry.register(Gauge(
    "kueue_pending_workloads", "Pending workloads per CQ and status",
    ("cluster_queue", "status")))
local_queue_pending_workloads = registry.register(Gauge(
    "kueue_local_queue_pending_workloads",
    "Pending workloads per LocalQueue and status",
    ("local_queue", "namespace", "status")))
reserving_active_workloads = registry.register(Gauge(
    "kueue_reserving_active_workloads",
    "Workloads with reserved quota per CQ", ("cluster_queue",)))
admitted_active_workloads = registry.register(Gauge(
    "kueue_admitted_active_workloads",
    "Admitted not-finished workloads per CQ", ("cluster_queue",)))
cluster_queue_status = registry.register(Gauge(
    "kueue_cluster_queue_status", "CQ status by condition",
    ("cluster_queue", "status")))

# -- workload flow counters (metrics.go:402-673) -----------------------------

quota_reserved_workloads_total = registry.register(Counter(
    "kueue_quota_reserved_workloads_total",
    "Total workloads that got quota reserved", ("cluster_queue",)))
admitted_workloads_total = registry.register(Counter(
    "kueue_admitted_workloads_total",
    "Total admitted workloads", ("cluster_queue",)))
finished_workloads_total = registry.register(Counter(
    "kueue_finished_workloads_total",
    "Total finished workloads", ("cluster_queue",)))
evicted_workloads_total = registry.register(Counter(
    "kueue_evicted_workloads_total",
    "Total evicted workloads by reason", ("cluster_queue", "reason")))
preempted_workloads_total = registry.register(Counter(
    "kueue_preempted_workloads_total",
    "Total preempted workloads by reason", ("preempting_cluster_queue", "reason")))
replaced_workload_slices_total = registry.register(Counter(
    "kueue_replaced_workload_slices_total",
    "Total workload slices replaced by a scaled-up slice", ("cluster_queue",)))

quota_reserved_wait_time_seconds = registry.register(Histogram(
    "kueue_quota_reserved_wait_time_seconds",
    "Time from creation to quota reservation", ("cluster_queue",),
    buckets=WAIT_BUCKETS))
admission_wait_time_seconds = registry.register(Histogram(
    "kueue_admission_wait_time_seconds",
    "Time from creation to admission", ("cluster_queue",),
    buckets=WAIT_BUCKETS))
admission_checks_wait_time_seconds = registry.register(Histogram(
    "kueue_admission_checks_wait_time_seconds",
    "Time from quota reservation to admission", ("cluster_queue",),
    buckets=WAIT_BUCKETS))

# -- quota gauges (metrics.go:733-804) ---------------------------------------

cluster_queue_resource_usage = registry.register(Gauge(
    "kueue_cluster_queue_resource_usage", "Current usage per CQ/flavor/resource",
    ("cluster_queue", "flavor", "resource")))
cluster_queue_resource_reservation = registry.register(Gauge(
    "kueue_cluster_queue_resource_reservation",
    "Currently reserved quantity per CQ/flavor/resource",
    ("cluster_queue", "flavor", "resource")))
cluster_queue_nominal_quota = registry.register(Gauge(
    "kueue_cluster_queue_nominal_quota", "Nominal quota per CQ/flavor/resource",
    ("cluster_queue", "flavor", "resource")))
cluster_queue_borrowing_limit = registry.register(Gauge(
    "kueue_cluster_queue_borrowing_limit",
    "Borrowing limit per CQ/flavor/resource",
    ("cluster_queue", "flavor", "resource")))
cluster_queue_lending_limit = registry.register(Gauge(
    "kueue_cluster_queue_lending_limit",
    "Lending limit per CQ/flavor/resource",
    ("cluster_queue", "flavor", "resource")))

# -- fair sharing (metrics.go:805-830) ---------------------------------------

cluster_queue_weighted_share = registry.register(Gauge(
    "kueue_cluster_queue_weighted_share",
    "DominantResourceShare of the CQ (x1000, weighted)", ("cluster_queue",)))
cohort_weighted_share = registry.register(Gauge(
    "kueue_cohort_weighted_share",
    "DominantResourceShare of the cohort (x1000, weighted)", ("cohort",)))

# -- LocalQueue family (metrics.go local_queue_* series; gate
# LocalQueueMetrics) ----------------------------------------------------------

local_queue_quota_reserved_workloads_total = registry.register(Counter(
    "kueue_local_queue_quota_reserved_workloads_total",
    "Total workloads with quota reserved per LocalQueue",
    ("local_queue", "namespace")))
local_queue_admitted_workloads_total = registry.register(Counter(
    "kueue_local_queue_admitted_workloads_total",
    "Total admitted workloads per LocalQueue", ("local_queue", "namespace")))
local_queue_evicted_workloads_total = registry.register(Counter(
    "kueue_local_queue_evicted_workloads_total",
    "Total evicted workloads per LocalQueue by reason",
    ("local_queue", "namespace", "reason")))
local_queue_finished_workloads_total = registry.register(Counter(
    "kueue_local_queue_finished_workloads_total",
    "Total finished workloads per LocalQueue", ("local_queue", "namespace")))
local_queue_reserving_active_workloads = registry.register(Gauge(
    "kueue_local_queue_reserving_active_workloads",
    "Workloads with reserved quota per LocalQueue",
    ("local_queue", "namespace")))
local_queue_admitted_active_workloads = registry.register(Gauge(
    "kueue_local_queue_admitted_active_workloads",
    "Admitted not-finished workloads per LocalQueue",
    ("local_queue", "namespace")))
local_queue_status = registry.register(Gauge(
    "kueue_local_queue_status", "LocalQueue status by condition",
    ("local_queue", "namespace", "status")))
local_queue_resource_usage = registry.register(Gauge(
    "kueue_local_queue_resource_usage",
    "Current usage per LocalQueue/flavor/resource",
    ("local_queue", "namespace", "flavor", "resource")))
local_queue_resource_reservation = registry.register(Gauge(
    "kueue_local_queue_resource_reservation",
    "Currently reserved quantity per LocalQueue/flavor/resource",
    ("local_queue", "namespace", "flavor", "resource")))
local_queue_quota_reserved_wait_time_seconds = registry.register(Histogram(
    "kueue_local_queue_quota_reserved_wait_time_seconds",
    "Time from creation to quota reservation per LocalQueue",
    ("local_queue", "namespace"), buckets=WAIT_BUCKETS))
local_queue_admission_wait_time_seconds = registry.register(Histogram(
    "kueue_local_queue_admission_wait_time_seconds",
    "Time from creation to admission per LocalQueue",
    ("local_queue", "namespace"), buckets=WAIT_BUCKETS))

# -- cohort subtree family (metrics.go cohort_subtree_*) ----------------------

cohort_subtree_quota = registry.register(Gauge(
    "kueue_cohort_subtree_quota",
    "Subtree quota per cohort/flavor/resource",
    ("cohort", "flavor", "resource")))
cohort_subtree_resource_reservations = registry.register(Gauge(
    "kueue_cohort_subtree_resource_reservations",
    "Reserved quantity in the cohort subtree per flavor/resource",
    ("cohort", "flavor", "resource")))
cohort_subtree_admitted_active_workloads = registry.register(Gauge(
    "kueue_cohort_subtree_admitted_active_workloads",
    "Admitted not-finished workloads in the cohort subtree", ("cohort",)))
cohort_subtree_admitted_workloads_total = registry.register(Counter(
    "kueue_cohort_subtree_admitted_workloads_total",
    "Total workloads admitted in the cohort subtree", ("cohort",)))

# -- eviction / readiness detail (metrics.go) ---------------------------------

evicted_workloads_once_total = registry.register(Counter(
    "kueue_evicted_workloads_once_total",
    "Workloads evicted at least once, by reason (first eviction only)",
    ("cluster_queue", "reason")))
finished_workloads_gauge = registry.register(Gauge(
    "kueue_finished_workloads",
    "Finished workloads currently retained per CQ", ("cluster_queue",)))
admitted_until_ready_wait_time_seconds = registry.register(Histogram(
    "kueue_admitted_until_ready_wait_time_seconds",
    "Time from admission until all pods ready", ("cluster_queue",),
    buckets=WAIT_BUCKETS))
ready_wait_time_seconds = registry.register(Histogram(
    "kueue_ready_wait_time_seconds",
    "Time from creation until all pods ready", ("cluster_queue",),
    buckets=WAIT_BUCKETS))
pods_ready_to_evicted_time_seconds = registry.register(Histogram(
    "kueue_pods_ready_to_evicted_time_seconds",
    "Time between pods becoming ready and the workload's eviction",
    ("cluster_queue", "reason"), buckets=WAIT_BUCKETS))
workload_creation_latency_seconds = registry.register(Histogram(
    "kueue_workload_creation_latency_seconds",
    "Time from job creation to its Workload object creation",
    ("job_kind",), buckets=WAIT_BUCKETS))
workload_eviction_latency_seconds = registry.register(Histogram(
    "kueue_workload_eviction_latency_seconds",
    "Time from the Evicted condition turning True until quota released "
    "(metrics.go:654-666; ~0 for synchronous in-process evictions, >0 "
    "when a deferred flow set the condition earlier)",
    ("cluster_queue", "reason"), buckets=WAIT_BUCKETS))
local_queue_admission_checks_wait_time_seconds = registry.register(
    Histogram("kueue_local_queue_admission_checks_wait_time_seconds",
              "Per-LQ time waiting on admission checks",
              ("local_queue", "namespace"), buckets=WAIT_BUCKETS))
local_queue_admitted_until_ready_wait_time_seconds = registry.register(
    Histogram("kueue_local_queue_admitted_until_ready_wait_time_seconds",
              "Per-LQ time from admission until all pods ready",
              ("local_queue", "namespace"), buckets=WAIT_BUCKETS))
local_queue_ready_wait_time_seconds = registry.register(
    Histogram("kueue_local_queue_ready_wait_time_seconds",
              "Per-LQ time from creation until all pods ready",
              ("local_queue", "namespace"), buckets=WAIT_BUCKETS))
local_queue_finished_workloads_gauge = registry.register(Gauge(
    "kueue_local_queue_finished_workloads",
    "Finished workloads currently retained per LQ",
    ("local_queue", "namespace")))
cluster_queue_resource_pending = registry.register(Gauge(
    "kueue_cluster_queue_resource_pending",
    "Pending requested quantity per CQ/resource",
    ("cluster_queue", "resource")))
build_info = registry.register(Gauge(
    "kueue_build_info", "Build metadata", ("version",)))
build_info.set("kueue-oss-tpu-r3", value=1)

# -- solver-specific (new; no reference analog) ------------------------------

solver_cycle_duration_seconds = registry.register(Histogram(
    "kueue_tpu_solver_cycle_duration_seconds",
    "Wall time of one batched TPU solve", ("phase",)))
solver_plan_fallbacks_total = registry.register(Counter(
    "kueue_tpu_solver_plan_fallbacks_total",
    "Solver plans rejected by the host oracle re-check", ()))

# -- solver backend resilience (sidecar transport + circuit breaker) ---------

solver_remote_retries_total = registry.register(Counter(
    "kueue_tpu_solver_remote_retries_total",
    "Remote solve attempts retried after a transport fault", ()))
solver_remote_failures_total = registry.register(Counter(
    "kueue_tpu_solver_remote_failures_total",
    "Remote solve attempt failures by kind "
    "(timeout/protocol/connection/server)", ("kind",)))
solver_deadline_exceeded_total = registry.register(Counter(
    "kueue_tpu_solver_deadline_exceeded_total",
    "Remote solves abandoned at the per-call deadline", ()))
solver_fallback_total = registry.register(Counter(
    "kueue_tpu_solver_fallback_total",
    "Backlog drains degraded to the host cycle path by reason",
    ("reason",)))
solver_breaker_trips_total = registry.register(Counter(
    "kueue_tpu_solver_breaker_trips_total",
    "Solver circuit breaker transitions into the open state", ()))
solver_breaker_state = registry.register(Gauge(
    "kueue_tpu_solver_breaker_state",
    "Solver breaker state (0 closed, 1 half-open, 2 open)", ()))
solver_plan_rejected_total = registry.register(Counter(
    "kueue_tpu_solver_plan_rejected_total",
    "Imported plans rejected wholesale by the sanity guard", ()))
degradation_level = registry.register(Gauge(
    "kueue_degradation_level",
    "Current degradation ladder level per subsystem (0 = healthy; "
    "see docs/ROBUSTNESS.md 'Degradation ladder')", ("subsystem",)))
degradation_transitions_total = registry.register(Counter(
    "kueue_degradation_transitions_total",
    "Degradation condition transitions (direction: degrade/recover)",
    ("subsystem", "direction")))

# -- delta-sync solver sessions (docs/SOLVER_PROTOCOL.md) --------------------

solver_resync_total = registry.register(Counter(
    "kueue_tpu_solver_resync_total",
    "Session full-resyncs forced by a sidecar state divergence, by "
    "reason (session_missing/epoch_mismatch/checksum_mismatch/...)",
    ("reason",)))
solver_session_frames_total = registry.register(Counter(
    "kueue_tpu_solver_session_frames_total",
    "Solver request frames shipped by kind (sync/delta/resync/legacy)",
    ("kind",)))
solver_session_bytes_total = registry.register(Counter(
    "kueue_tpu_solver_session_bytes_total",
    "Solver request payload bytes shipped by frame kind", ("kind",)))
solver_session_evictions_total = registry.register(Counter(
    "kueue_tpu_solver_session_evictions_total",
    "Sidecar session-table evictions by reason (lru = capacity "
    "pressure past max_sessions; tenant_evicted = a whole tenant "
    "namespace dropped by the farm/chaos layer)", ("reason",)))

# -- federation / multi-tenant solver farm (docs/FEDERATION.md) --------------

solver_farm_requests_total = registry.register(Counter(
    "kueue_tpu_solver_farm_requests_total",
    "Solver farm requests admitted to the executor, by tenant", ("tenant",)))
solver_farm_wall_seconds_total = registry.register(Counter(
    "kueue_tpu_solver_farm_wall_seconds_total",
    "Solver wall-time consumed on the shared farm, by tenant (the "
    "quantity the deficit-round-robin scheduler arbitrates)",
    ("tenant",)))
solver_farm_throttled_total = registry.register(Counter(
    "kueue_tpu_solver_farm_throttled_total",
    "Farm requests rejected with backpressure (per-tenant queue "
    "overflow; the client degrades to host cycles via "
    "SolverUnavailable)", ("tenant",)))
solver_farm_tenants = registry.register(Gauge(
    "kueue_tpu_solver_farm_tenants",
    "Distinct tenants with live state on the shared solver farm", ()))
solver_farm_grant_wait_seconds = registry.register(Histogram(
    "kueue_tpu_solver_farm_grant_wait_seconds",
    "Seconds between a solve request's arrival at the farm and its "
    "DRR grant (the queue-wait the deficit scheduler imposes), by "
    "tenant", ("tenant",),
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)))

# -- device telemetry (obs/devtel.py, docs/OBSERVABILITY.md) -----------------

solver_compiles_total = registry.register(Counter(
    "kueue_tpu_solver_compiles_total",
    "First-call XLA compilations detected per (kernel, arm, pow2 "
    "shape bucket) by the devtel compile detector",
    ("kernel", "arm", "bucket")))
solver_compile_seconds = registry.register(Histogram(
    "kueue_tpu_solver_compile_seconds",
    "Wall seconds of solves flagged as compile-bearing (first call "
    "for a (kernel, arm, shape-bucket); upper-bounds compile time — "
    "the wall includes the traced execution)", (),
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0, 60.0)))
solver_transfer_bytes_total = registry.register(Counter(
    "kueue_tpu_solver_transfer_bytes_total",
    "Host<->device and wire transfer bytes by direction (h2d = "
    "uploads incl. donated deltas; avoided = copies elided by "
    "donation/aliasing; tx = request frames on the sidecar wire), "
    "arm, and tenant", ("direction", "arm", "tenant")))
solver_hbm_resident_bytes = registry.register(Gauge(
    "kueue_tpu_solver_hbm_resident_bytes",
    "Bytes of solver problem state resident on device after the last "
    "drain (portable bookkeeping over the delta-session buffers)", ()))
solver_hbm_bytes_in_use = registry.register(Gauge(
    "kueue_tpu_solver_hbm_bytes_in_use",
    "Device-reported bytes_in_use per device (memory_stats(); absent "
    "on backends that do not expose allocator stats)", ("device",)))
solver_deep_captures_total = registry.register(Counter(
    "kueue_tpu_solver_deep_captures_total",
    "Tail-based deep-capture sessions by trigger "
    "(slo_burn/phase_regression/manual) and outcome "
    "(started/suppressed_cooldown/suppressed_busy/disarmed)",
    ("trigger", "outcome")))

# -- federated dispatch (multikueue/dispatcher.py WhatIf strategy) -----------

multikueue_whatif_dispatch_total = registry.register(Counter(
    "kueue_multikueue_whatif_dispatch_total",
    "What-if-scored dispatch decisions by outcome (scored = batched "
    "pricer nominated a cluster; fallback = farm/pricer unavailable, "
    "degraded to Incremental; deferred = outstanding nomination still "
    "within its round timeout)", ("outcome",)))
multikueue_dispatch_score_ms = registry.register(Histogram(
    "kueue_multikueue_dispatch_score_ms",
    "Wall milliseconds spent pricing one dispatch across candidate "
    "clusters with the batched what-if solve", (),
    buckets=(1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
             1000.0, 2500.0)))

# -- columnar export-path health (solver/columnar.py) ------------------------

columnar_bailouts_total = registry.register(Counter(
    "kueue_tpu_columnar_bailouts_total",
    "Columnar exports that bailed out to the classic dict walk, by "
    "reason (afs_active = AdmissionFairSharing consulted, column "
    "store cannot price usage-ordering; retry_exhausted = concurrent "
    "mutation raced the lock-free snapshot three times)", ("reason",)))

# -- mesh-sharded drains (solver/sharded.py, docs/SOLVER_PROTOCOL.md) --------

solver_mesh_devices = registry.register(Gauge(
    "kueue_tpu_solver_mesh_devices",
    "Devices in the solver mesh used by the most recent drain "
    "(0 = single-chip / host path)", ()))
solver_shard_imbalance = registry.register(Histogram(
    "kueue_tpu_solver_shard_imbalance",
    "Real-row imbalance across mesh shards per drain "
    "((max - min) / mean occupied rows; 0 = perfectly even)", (),
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0)))
solver_multihost_processes = registry.register(Gauge(
    "kueue_tpu_solver_multihost_processes",
    "jax processes in the pod-scale solver bootstrap "
    "(1 = single-host; set by service.serve_multihost)", ()))

# -- convex-relaxation fast-path arm (solver/relax.py) -----------------------

solver_relax_drains_total = registry.register(Counter(
    "kueue_tpu_solver_relax_drains_total",
    "Relaxed-arm solves by outcome (served = relax plan emitted; "
    "audit_match / audit_diverged = exact-kernel disagreement audits; "
    "error = arm fault, drain fell back to an exact arm)",
    ("outcome",)))
solver_relax_support_fraction = registry.register(Histogram(
    "kueue_tpu_solver_relax_support_fraction",
    "Rounded support size as a fraction of live backlog rows per "
    "relaxed solve", (),
    buckets=(0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0)))

# -- streaming control plane (scheduler/streaming.py) ------------------------

stream_microdrains_total = registry.register(Counter(
    "kueue_stream_microdrains_total",
    "Micro-batched sub-cycle admission drains by outcome (admitted / "
    "parked = only no-fit parkings / deferred = every pending CQ "
    "fenced to the next full solve / idle)", ("outcome",)))
stream_admitted_total = registry.register(Counter(
    "kueue_stream_admitted_total",
    "Workloads admitted sub-cycle by the streaming fast path", ()))
stream_demotions_total = registry.register(Counter(
    "kueue_stream_demotions_total",
    "Fast-path demotions by fence reason (cohort_event / spec_change "
    "/ borrow_capable / out_of_order / unsupported / "
    "flavor_witness_invalid = a capacity event could flip the "
    "full-solve flavor pick / headroom_exhausted = the admission "
    "needed borrowed capacity or overran the reserved nominal-"
    "headroom budget / watch_coalesced = arrival signals absorbed "
    "into an already-running watch-driven micro-drain under burst "
    "backpressure, not a fence) — fence reasons defer the subtree "
    "to the next full solve",
    ("reason",)))
stream_eligible_fraction = registry.register(Gauge(
    "kueue_stream_eligible_fraction",
    "Fraction of pending ClusterQueues the last micro-drain walked "
    "on the streaming fast path (1 - deferred/considered; the "
    "coverage the wide fences buy over the structural PR-11 fences)",
    ()))
stream_spec_solves_total = registry.register(Counter(
    "kueue_stream_spec_solves_total",
    "Full solves pulled forward because a spec edit (quota/flavor "
    "change, node flap) was observed mid-window by the streaming "
    "fast path", ()))

# -- decision flight recorder (obs/) -----------------------------------------

decision_events_total = registry.register(Counter(
    "kueue_decision_events_total",
    "Flight-recorder decision events by kind", ("kind",)))
decision_skips_total = registry.register(Counter(
    "kueue_decision_skips_total",
    "Workload skip/fallback decisions by bounded reason slug",
    ("reason",)))

# -- what-if engine (kueue_oss_tpu/sim/, docs/SIMULATOR.md) ------------------

whatif_scenarios_total = registry.register(Counter(
    "kueue_tpu_whatif_scenarios_total",
    "Counterfactual scenarios solved by the what-if engine, by mode "
    "(batched/sequential/trace)", ("mode",)))
whatif_batches_total = registry.register(Counter(
    "kueue_tpu_whatif_batches_total",
    "Vmapped what-if batch dispatches", ()))
whatif_batch_width = registry.register(Histogram(
    "kueue_tpu_whatif_batch_width",
    "Scenario-axis width of what-if batch dispatches (pow2-padded)", (),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)))
whatif_duration_seconds = registry.register(Histogram(
    "kueue_tpu_whatif_duration_seconds",
    "What-if engine wall time by phase (build/solve/parity/report)",
    ("phase",)))
whatif_round_buckets_total = registry.register(Counter(
    "kueue_tpu_whatif_round_buckets_total",
    "What-if scenarios dispatched per predicted-round-count bucket "
    "(round-skew bucketing keeps short lanes out of long batches)",
    ("bucket",)))
whatif_parity_failures_total = registry.register(Counter(
    "kueue_tpu_whatif_parity_failures_total",
    "What-if batches whose vmapped plans diverged from the sequential "
    "oracle (must stay 0; a nonzero count is a kernel bug)", ()))
whatif_retier_total = registry.register(Counter(
    "kueue_tpu_whatif_retier_total",
    "What-if scenarios re-tiered from the FULL kernel to the relax-LP "
    "approximate tier by the lane-budget planner, by reason — every "
    "re-tier is reported per scenario row; none may happen silently",
    ("reason",)))
whatif_full_chunks_total = registry.register(Counter(
    "kueue_tpu_whatif_full_chunks_total",
    "Lane-budgeted FULL-kernel sweep chunk dispatches", ()))
whatif_resident_syncs_total = registry.register(Counter(
    "kueue_tpu_whatif_resident_syncs_total",
    "ResidentSweep device-state refreshes by kind (full upload on "
    "spec-gen change / row scatter on workload churn / reuse when "
    "nothing moved)", ("kind",)))

# -- cluster health layer (obs/health.py + obs/ledger.py,
# docs/OBSERVABILITY.md "Cluster health & SLOs") -----------------------------

slo_burn_rate = registry.register(Gauge(
    "kueue_slo_burn_rate",
    "Queue-wait SLO burn rate per scope/key/window (1.0 = exactly "
    "consuming the error budget; alerting thresholds sit well above)",
    ("scope", "key", "window")))
slo_alerts_firing = registry.register(Gauge(
    "kueue_slo_alerts_firing",
    "Burn-rate alerts currently firing per scope/key (0 or 1)",
    ("scope", "key")))
slo_alert_transitions_total = registry.register(Counter(
    "kueue_slo_alert_transitions_total",
    "Burn-rate alert state transitions by direction (fired/cleared)",
    ("scope", "key", "state")))
starvation_oldest_pending_seconds = registry.register(Gauge(
    "kueue_starvation_oldest_pending_seconds",
    "Age of the oldest pending workload per CQ at the last SLO "
    "evaluation (the starvation watchdog's primary signal)",
    ("cluster_queue",)))
ledger_records_total = registry.register(Counter(
    "kueue_ledger_records_total",
    "Cycle-ledger rows recorded, by kind (host/solver/stream)",
    ("kind",)))
slo_alert_deliveries_total = registry.register(Counter(
    "kueue_slo_alert_deliveries_total",
    "Alert-sink notifications on burn-rate fire/clear transitions, "
    "by outcome (ok/error)", ("outcome",)))
cycle_phase_regression = registry.register(Gauge(
    "kueue_cycle_phase_regression",
    "1 while the fast EWMA of a cycle phase's wall exceeds the "
    "regression ratio over its slow baseline (ledger-driven "
    "regression detection), else 0", ("kind", "phase")))
cycle_phase_regression_ratio = registry.register(Gauge(
    "kueue_cycle_phase_regression_ratio",
    "Fast-EWMA / slow-baseline ratio per cycle phase (1.0 = at "
    "baseline)", ("kind", "phase")))

# -- durable control plane (persist/, docs/DURABILITY.md) --------------------

wal_records_total = registry.register(Counter(
    "kueue_wal_records_total",
    "Write-ahead-log records appended, by kind (event/intent)",
    ("kind",)))
wal_bytes_total = registry.register(Counter(
    "kueue_wal_bytes_total",
    "Write-ahead-log bytes appended (frame headers included)", ()))
wal_fsyncs_total = registry.register(Counter(
    "kueue_wal_fsyncs_total",
    "fsync barriers issued by the write-ahead log", ()))
wal_fsync_faults_total = registry.register(Counter(
    "kueue_wal_fsync_faults_total",
    "fsync failures absorbed by the WAL durability ladder "
    "(always -> batch -> off; docs/ROBUSTNESS.md)", ()))
checkpoints_total = registry.register(Counter(
    "kueue_checkpoints_total",
    "Store checkpoints by outcome (written = full / incremental / "
    "failed)", ("outcome",)))
checkpoint_duration_seconds = registry.register(Histogram(
    "kueue_checkpoint_duration_seconds",
    "Wall time of one atomic checkpoint (serialize + fsync + rotate)",
    ()))
checkpoint_bytes = registry.register(Gauge(
    "kueue_checkpoint_bytes",
    "Payload bytes of the most recent checkpoint, by kind "
    "(full/incremental)", ("kind",)))
wal_shipped_bytes_total = registry.register(Counter(
    "kueue_wal_shipped_bytes_total",
    "Bytes shipped to the warm standby, by stream (tail = synced "
    "active-segment suffix / sealed = rotated segments / checkpoint)",
    ("stream",)))
wal_compaction_dropped_total = registry.register(Counter(
    "kueue_wal_compaction_dropped_total",
    "Records dropped by per-key log compaction during sealed-segment "
    "shipping (superseded events + satisfied intents)", ()))
wal_standby_rebootstraps_total = registry.register(Counter(
    "kueue_wal_standby_rebootstraps_total",
    "Warm-standby re-bootstraps from a newer shipped checkpoint that "
    "superseded the replay frontier", ()))
wal_standby_pruned_total = registry.register(Counter(
    "kueue_wal_standby_pruned_total",
    "Superseded shipped files (retired segments, out-of-chain "
    "checkpoints) deleted by the warm standby's GC", ()))
recovery_total = registry.register(Counter(
    "kueue_recovery_total",
    "Recoveries by source (checkpoint/wal_only/empty)", ("source",)))
recovery_replayed_records = registry.register(Gauge(
    "kueue_recovery_replayed_records",
    "WAL records replayed by the most recent recovery", ()))
invariant_audits_total = registry.register(Counter(
    "kueue_invariant_audits_total",
    "Invariant auditor passes completed", ()))
invariant_violations_total = registry.register(Counter(
    "kueue_invariant_violations_total",
    "Accounting invariant violations detected, by check "
    "(must stay 0; a nonzero count means derived state drifted from "
    "the admission records)", ("check",)))
invariant_heals_total = registry.register(Counter(
    "kueue_invariant_heals_total",
    "Auto-heal index rebuilds performed by the invariant auditor", ()))
invariant_audit_errors_total = registry.register(Counter(
    "kueue_invariant_audit_errors_total",
    "Background audit passes that crashed internally (an auditor "
    "defect, NOT state drift — the violations counter stays clean)",
    ()))
invariant_last_violations = registry.register(Gauge(
    "kueue_invariant_last_violations",
    "Violations found by the most recent audit pass", ()))


# -- recording helpers (reference: pkg/metrics exported funcs) ---------------

class CycleResult:
    SUCCESS = "success"
    INADMISSIBLE = "inadmissible"


def observe_admission_attempt(result: str, duration_s: float) -> None:
    admission_attempts_total.inc(result)
    admission_attempt_duration_seconds.observe(result, value=duration_s)


def report_pending_workloads(cq: str, active: int, inadmissible: int) -> None:
    pending_workloads.set(cq, "active", value=active)
    pending_workloads.set(cq, "inadmissible", value=inadmissible)


def _lq_metrics_enabled() -> bool:
    from kueue_oss_tpu_torch import features

    return features.enabled("LocalQueueMetrics")


# ---------------------------------------------------------------------------
# custom metric labels (gate CustomMetricLabels; pkg/metrics/custom_labels.go)
# ---------------------------------------------------------------------------

#: configured ClusterQueue label keys appended to per-CQ series
_custom_cq_keys: list[str] = []
#: cq name -> resolved label values (parallel to _custom_cq_keys)
_custom_cq_values: dict[str, tuple[str, ...]] = {}


def configure_custom_labels(cq_label_keys: list[str]) -> None:
    """Extend the per-CQ admission series with values taken from each
    ClusterQueue's object labels (reference custom_labels.go: the metric
    vecs are rebuilt with the extended label set at config time). The
    gate is consulted HERE, at configure time, so the series label
    tuples and the emit-time value tuples can never disagree."""
    from kueue_oss_tpu_torch import features

    global _custom_cq_keys
    if not features.enabled("CustomMetricLabels"):
        cq_label_keys = []
    _custom_cq_keys = list(cq_label_keys)
    _custom_cq_values.clear()
    extra = tuple("label_" + k.replace("/", "_").replace(".", "_").
                  replace("-", "_") for k in cq_label_keys)
    for series in (admitted_workloads_total, admission_wait_time_seconds,
                   quota_reserved_workloads_total,
                   quota_reserved_wait_time_seconds):
        base = series.labels[:1]          # ("cluster_queue",)
        series.labels = base + extra


def record_cq_labels(cq_name: str, labels: dict) -> None:
    """Resolve + store a CQ's custom label values; a change clears the
    CQ's stale series (CustomLabelStore.StoreAndClear)."""
    if not _custom_cq_keys:
        return
    vals = tuple(labels.get(k, "") for k in _custom_cq_keys)
    old = _custom_cq_values.get(cq_name)
    if old is not None and old != vals:
        for series in (admitted_workloads_total,
                       admission_wait_time_seconds,
                       quota_reserved_workloads_total,
                       quota_reserved_wait_time_seconds):
            series.delete_matching(cluster_queue=cq_name)
    _custom_cq_values[cq_name] = vals


def _cq_labels(cq: str) -> tuple:
    if not _custom_cq_keys:
        return (cq,)
    return (cq,) + _custom_cq_values.get(
        cq, ("",) * len(_custom_cq_keys))


def admitted_workload(cq: str, wait_s: float, lq: str = "",
                      namespace: str = "default",
                      exemplar: Optional[dict] = None) -> None:
    """``exemplar`` (e.g. {"cycle": "17", "workload": "ns/w"}) rides
    the wait-time histogram so a latency bucket links back to the
    exact ledger row and decision chain (docs/OBSERVABILITY.md)."""
    admitted_workloads_total.inc(*_cq_labels(cq))
    admission_wait_time_seconds.observe(*_cq_labels(cq),
                                        value=max(wait_s, 0.0),
                                        exemplar=exemplar)
    if lq and _lq_metrics_enabled():
        local_queue_admitted_workloads_total.inc(lq, namespace)
        local_queue_admission_wait_time_seconds.observe(
            lq, namespace, value=max(wait_s, 0.0))


def quota_reserved_workload(cq: str, wait_s: float, lq: str = "",
                            namespace: str = "default",
                            exemplar: Optional[dict] = None) -> None:
    quota_reserved_workloads_total.inc(*_cq_labels(cq))
    quota_reserved_wait_time_seconds.observe(*_cq_labels(cq),
                                             value=max(wait_s, 0.0),
                                             exemplar=exemplar)
    if lq and _lq_metrics_enabled():
        local_queue_quota_reserved_workloads_total.inc(lq, namespace)
        local_queue_quota_reserved_wait_time_seconds.observe(
            lq, namespace, value=max(wait_s, 0.0))


def report_cluster_queue_quotas(cq: str, quotas) -> None:
    """quotas: iterable of ((flavor, resource), ResourceQuota)."""
    for (flavor, resource), rq in quotas:
        cluster_queue_nominal_quota.set(cq, flavor, resource, value=rq.nominal)
        if rq.borrowing_limit is not None:
            cluster_queue_borrowing_limit.set(
                cq, flavor, resource, value=rq.borrowing_limit)
        if rq.lending_limit is not None:
            cluster_queue_lending_limit.set(
                cq, flavor, resource, value=rq.lending_limit)


def report_cluster_queue_usage(cq: str, usage: dict, spec_frs=None) -> None:
    """spec_frs: every (flavor, resource) pair in the CQ's spec. Pairs whose
    usage dropped to zero are absent from the snapshot usage dict but must
    still report 0 — the reference emits a sample for every configured pair
    (metrics.go ReportClusterQueueQuotas/usage, :733+)."""
    if spec_frs is not None:
        for fr in spec_frs:
            if fr not in usage:
                flavor, resource = fr
                cluster_queue_resource_usage.set(
                    cq, flavor, resource, value=0)
                cluster_queue_resource_reservation.set(
                    cq, flavor, resource, value=0)
    for (flavor, resource), q in usage.items():
        cluster_queue_resource_usage.set(cq, flavor, resource, value=q)
        cluster_queue_resource_reservation.set(cq, flavor, resource, value=q)


def clear_cluster_queue_metrics(cq: str) -> None:
    """Reference parity: metrics.ClearClusterQueueResourceMetrics on CQ delete."""
    for series in (cluster_queue_resource_usage,
                   cluster_queue_resource_reservation,
                   cluster_queue_nominal_quota,
                   cluster_queue_borrowing_limit,
                   cluster_queue_lending_limit):
        series.delete_matching(cluster_queue=cq)
    for series in (pending_workloads, admission_cycle_preemption_skips,
                   reserving_active_workloads, admitted_active_workloads,
                   cluster_queue_status, cluster_queue_weighted_share):
        series.delete_matching(cluster_queue=cq)


def reset_all() -> None:
    """Test helper: drop every recorded sample (registry keeps its series)."""
    for s in registry._series_snapshot():
        s._values = {}  # type: ignore[attr-defined]
        if isinstance(s, Histogram):
            s._exemplars = {}

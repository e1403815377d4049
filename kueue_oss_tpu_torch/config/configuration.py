"""Framework configuration.

A copy of ``kueue_oss_tpu/config/configuration.py`` (reference:
apis/config/v1beta2/configuration_types.go:34-114, the Configuration
file CRD, and pkg/config Load / Validate): the Configuration tree as
dataclasses, loadable from a plain (YAML-decoded) dict with the
reference's camelCase keys, ``validate`` with the JAX package's
messages in its order, ``apply_feature_gates`` and
``apply_resource_transformations``. Durations are plain float seconds.

The port acts on the sections it has modules for: ``solver``
(``Scheduler(solver_config=...)``, ``SolverClient.from_config``),
``federation`` (``federation.FarmScheduler.from_config``),
``streaming``, ``simulator``, ``resources`` (installed with
``core.workload_info.set_resources_config``), ``admissionFairSharing``
(``core.afs.AfsManager``) and ``featureGates``. ``persistence``,
``observability`` (its ``slo`` and ``devtel``) and ``resilience`` are
carried as data: the persistence layer is ROADMAP Queue A item 14, the
observability layer and the degradation ladder item 13. A switch that
asks for what the port does not do raises, so no stated durability or
alerting goes missing unseen: ``persistence.enabled``,
``observability.devtel.enabled`` / ``captureEnabled`` and
``observability.slo.alertWebhookUrl``. Switches that turn a layer off
load (the port runs none of it). The fields of the multi-device arms
(``solver.mesh``, the pod-scale coordinator, ``simulator.mesh``) raise
away from their defaults: Queue A item 9.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Optional

from kueue_oss_tpu_torch.util.tlsconfig import TLSOptions


class RequeuingTimestamp:
    """Reference parity: config RequeuingStrategy.Timestamp values."""

    EVICTION = "Eviction"
    CREATION = "Creation"


@dataclass
class RequeuingStrategy:
    """Backoff for WaitForPodsReady re-queues.

    Reference parity: configuration_types.go RequeuingStrategy —
    backoffBaseSeconds default 60, backoffMaxSeconds default 3600;
    backoffLimitCount None = unlimited retries, otherwise the workload is
    deactivated once the count is exhausted.
    """

    timestamp: str = RequeuingTimestamp.EVICTION
    backoff_limit_count: Optional[int] = None
    backoff_base_seconds: float = 60.0
    backoff_max_seconds: float = 3600.0


@dataclass
class WaitForPodsReady:
    """Reference parity: configuration_types.go WaitForPodsReady (KEP-349).

    enable=True makes admission conditional on pods becoming ready within
    `timeout`; on timeout the workload is evicted and re-queued with the
    RequeuingStrategy backoff. recovery_timeout bounds how long an admitted
    workload may sit with PodsReady=False after having been ready once.
    """

    enable: bool = False
    timeout_seconds: float = 300.0
    recovery_timeout_seconds: Optional[float] = None
    #: block all other admissions while a workload waits for pods ready
    block_admission: bool = False
    requeuing_strategy: RequeuingStrategy = field(default_factory=RequeuingStrategy)


@dataclass
class FairSharingConfig:
    """Reference parity: configuration_types.go FairSharing (KEP-1714)."""

    enable: bool = False
    #: ordered subset of {"LessThanOrEqualToFinalShare", "LessThanInitialShare"}
    preemption_strategies: list[str] = field(
        default_factory=lambda: ["LessThanOrEqualToFinalShare",
                                 "LessThanInitialShare"])


@dataclass
class AdmissionFairSharingConfig:
    """Reference parity: configuration_types.go AdmissionFairSharing (KEP-4136)."""

    usage_half_life_time_seconds: float = 300.0
    usage_sampling_interval_seconds: float = 10.0
    resource_weights: dict[str, float] = field(default_factory=dict)


@dataclass
class ResourceTransformation:
    """Reference parity: configuration_types.go ResourceTransformation —
    maps an input resource to weighted output resources when building a
    workload's quota usage. strategy Retain keeps the original resource as
    well; Replace drops it."""

    input: str
    strategy: str = "Retain"  # Retain | Replace
    outputs: dict[str, float] = field(default_factory=dict)


@dataclass
class ResourcesConfig:
    """Reference parity: configuration_types.go Resources."""

    exclude_resource_prefixes: list[str] = field(default_factory=list)
    transformations: list[ResourceTransformation] = field(default_factory=list)
    #: "IgnoreUndeclared" skips resources no ResourceGroup covers during
    #: quota checks instead of failing admission (gate QuotaCheckStrategy;
    #: flavorassigner.go IgnoreUndeclaredResources)
    quota_check_strategy: Optional[str] = None
    #: DRA: device class name -> logical resource name (KEP-2941)
    device_class_mappings: dict[str, str] = field(default_factory=dict)


@dataclass
class ObjectRetentionPolicies:
    """Reference parity: configuration_types.go ObjectRetentionPolicies —
    None = keep finished/deactivated workloads forever."""

    finished_workload_retention_seconds: Optional[float] = None
    deactivated_workload_retention_seconds: Optional[float] = None


@dataclass
class MultiKueueConfig:
    """Reference parity: configuration_types.go MultiKueue."""

    gc_interval_seconds: float = 60.0
    origin: str = "multikueue"
    worker_lost_timeout_seconds: float = 900.0
    #: dispatcher algorithm: AllAtOnce | Incremental
    dispatcher_name: str = "AllAtOnce"


@dataclass
class SolverBackendConfig:
    """Knobs of the solver backend (JAX ``SolverBackendConfig``).

    Ported: the remote sidecar (``socket_path`` routes the "auto"
    engine's solves through a ``SolverClient`` with the timeout, retry,
    frame and tenant fields; ``max_sessions`` is the sidecar's session
    cap), its breaker (``breaker_*``), delta sessions
    (``sessions_enabled``: None reads KUEUE_SOLVER_SESSIONS, default on)
    and the relaxed fast-path arm (``relax_*``), which
    ``Scheduler(solver_config=...)`` wires onto its engine. The mesh and
    pod-scale coordinator (ROADMAP Queue A item 9) are not ported: a
    field of theirs set away from its default raises.
    """

    #: unix socket of the sidecar; None = solve in-process
    socket_path: Optional[str] = None
    tenant: str = ""
    max_sessions: Optional[int] = None
    timeout_seconds: float = 600.0
    max_retries: int = 2
    retry_backoff_base_seconds: float = 0.05
    retry_backoff_max_seconds: float = 2.0
    max_frame_bytes: int = 256 << 20
    breaker_failure_threshold: int = 3
    breaker_cooldown_seconds: float = 30.0
    #: delta-sync sessions: None = KUEUE_SOLVER_SESSIONS env (default
    #: on); False turns them off
    sessions_enabled: Optional[bool] = None
    mesh: Optional[str] = None
    coordinator_address: Optional[str] = None
    coordinator_processes: int = 1
    coordinator_process_id: int = 0
    #: the relaxed arm (solver/relax.py): the cost-EMA router still
    #: decides per drain; disabling removes the arm
    relax_enabled: bool = True
    #: lean backlogs below this many live workloads never route to it
    relax_min_workloads: int = 4096
    #: every Nth relax-served drain also runs the exact solve and
    #: demotes the arm on plan divergence (0 disables auditing)
    relax_audit_every: int = 8
    #: fixed projected-gradient iteration count
    relax_iters: int = 32
    #: rounding threshold on the fractional admit vector, in (0, 1)
    relax_support_threshold: float = 0.5
    #: demoted-arm cooldown before one re-probe drain
    relax_retry_cooldown_seconds: float = 300.0

    #: the fields of the multi-device arms (ROADMAP Queue A item 9)
    _MESH = ("mesh", "coordinator_address", "coordinator_processes",
             "coordinator_process_id")

    def __post_init__(self) -> None:
        defaults = {f.name: f.default for f in fields(self)}
        for name in self._MESH:
            value = getattr(self, name)
            if value != defaults[name] and not (
                    name == "mesh" and value == "off"):
                raise NotImplementedError(
                    f"SolverBackendConfig.{name}: the multi-device arms, "
                    f"ROADMAP Queue A item 9")


@dataclass
class FederationConfig:
    """Multi-tenant solver-farm knobs (federation/).

    No reference analog — the reference has no shared solver service;
    these govern the sidecar-side weighted deficit-round-robin that
    arbitrates solver wall-time between the control planes sharing one
    farm. Applied via ``FarmScheduler.from_config`` and
    ``federation.attach_farm(server, scheduler)``.
    """

    #: tenant id -> DRR weight (share of solver wall-time); tenants
    #: absent here get default_weight
    tenant_weights: dict[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    #: wall-time credit granted per DRR ring visit, scaled by weight
    quantum_seconds: float = 0.025
    #: per-tenant queued-request cap; arrivals past it are rejected
    #: with an in-band backpressure error (the client degrades to host
    #: cycles via SolverUnavailable — it never wedges)
    max_queued: int = 8
    #: idle-credit cap, in quanta, bounding how large a burst a
    #: backlogged tenant can run from accrued deficit
    max_credit_quanta: float = 4.0


@dataclass
class ResilienceConfig:
    """Degradation-ladder knobs (the JAX package's resilience layer;
    carried as data here: the ladder waits for ROADMAP Queue A item 13).

    No reference analog — the reference has no explicit degraded-mode
    state machine; these govern the process-wide DegradationController
    every breaker/demotion/backpressure handler reports into.
    """

    enabled: bool = True
    #: bounded transition-history length kept for /api/degradation
    history_limit: int = 512
    #: quiet period before a degraded WAL durability policy gets one
    #: probe fsync (the persistence ladder's restore hysteresis)
    wal_restore_cooldown_seconds: float = 60.0


@dataclass
class PersistenceConfig:
    """Durable control plane knobs (the JAX package's persistence layer;
    carried as data here: the port has none).

    No reference analog — the reference delegates durability to the
    apiserver/etcd; here the control plane carries its own write-ahead
    log and checkpoints.
    """

    #: master switch; when False nothing is logged or checkpointed
    enabled: bool = False
    #: durability directory (wal-*.log + checkpoint-*.ckpt); required
    #: when enabled
    dir: Optional[str] = None
    #: WAL fsync policy: "always" (every record durable before the
    #: append returns), "batch" (group commit at cycle end / every
    #: batch_records — the <5% overhead default; WAL file order still
    #: fences intents before their events), "off" (tests/bench only)
    fsync: str = "batch"
    #: group-commit width under fsync=batch
    batch_records: int = 64
    #: checkpoint after this many WAL records...
    checkpoint_interval_records: int = 10_000
    #: ...or after this many seconds with any records pending
    #: (0 disables the time trigger)
    checkpoint_interval_seconds: float = 300.0
    #: validated checkpoints retained (older ones and their WAL
    #: segments are pruned on checkpoint success)
    keep_checkpoints: int = 2
    #: background invariant-auditor cadence; 0 disables the thread
    audit_interval_seconds: float = 0.0
    #: let the auditor rebuild drifted derived indexes automatically
    audit_auto_heal: bool = False
    #: incremental checkpoints (docs/DURABILITY.md "Incremental
    #: checkpoints"): delta against the previous checkpoint keyed by
    #: event-driven dirty tracking — sub-second cadences become
    #: affordable (a <5% dirty delta costs a small fraction of the
    #: full 50k-workload serialize)
    incremental_checkpoints: bool = False
    #: every Nth checkpoint is a full dump (bounds delta-chain length
    #: and recovery fan-in); the first after attach/recovery is
    #: always full
    full_checkpoint_every: int = 16
    #: WAL log shipping target directory (docs/DURABILITY.md "Log
    #: shipping"): every flush ships the synced tail, every rotation
    #: ships the sealed segment + checkpoint; None disables
    ship_to: Optional[str] = None
    #: per-key last-state-wins compaction of sealed segments during
    #: shipping (never alters the primary's own log)
    ship_compact: bool = True

    def __post_init__(self) -> None:
        if self.enabled:
            raise NotImplementedError(
                "PersistenceConfig.enabled: the port has no write-ahead "
                "log or checkpoints yet, ROADMAP Queue A item 14")


@dataclass
class SimulatorConfig:
    """What-if engine knobs (kueue_oss_tpu_torch/sim/).

    No reference analog — the reference Kueue has no counterfactual
    simulator; these bound the batched scenario sweeps.
    """

    #: hard cap on scenarios per batch (one batched dispatch solves
    #: them all; the cap bounds device memory, not correctness)
    max_scenarios: int = 256
    #: leading scenarios cross-checked bit-identically against the
    #: sequential single-problem oracle per run (0 disables)
    parity_scenarios: int = 2
    #: pad the scenario axis to a power of two (inert repeats of
    #: scenario 0), as the JAX engine does to reuse one compiled program
    pad_pow2: bool = True
    #: scenario-axis mesh sharding mode; only "off" runs here (the
    #: multi-device arms are ROADMAP Queue A item 9)
    mesh: str = "off"
    #: batches below this width stay single-device even with a mesh
    min_batch_for_mesh: int = 16
    #: round-skew bucketing: group scenarios by predicted round count
    #: so wide batches stop running every lane to the slowest
    #: scenario's round count
    round_bucketing: bool = True
    #: sweeps below this width dispatch as one batch regardless
    min_batch_for_bucketing: int = 8
    #: route sweeps through the FULL preemption drain by default
    #: (lane-budgeted chunks; per-run override via run(full=...)) —
    #: preemption-aware planning at a higher device cost
    full_kernel: bool = False
    #: device-byte budget the LaneBudget planner sizes FULL-sweep
    #: scenario chunks from (S x h_max x K x W lane accounting)
    lane_budget_mb: int = 256
    #: scenarios per sweep solved exactly on the FULL drain; overflow
    #: rows re-tier to the relax LP (reported per row, never silent)
    full_sweep_max: int = 256
    #: fixed LP iterations for the relax approximate tier
    relax_iters: int = 32

    def __post_init__(self) -> None:
        if str(self.mesh or "off") != "off":
            raise NotImplementedError(
                "SimulatorConfig.mesh: the scenario-axis mesh is ROADMAP "
                "Queue A item 9")


@dataclass
class StreamingConfig:
    """Streaming micro-batched admission knobs
    (scheduler/streaming.py).

    No reference analog — the reference schedules cycle-batch only;
    these govern the sub-cycle fast path that decouples p50
    time-to-admit from the full-solve cadence for uncontended CQs.
    """

    #: master switch; off = the cycle-batch model, unchanged
    enabled: bool = False
    #: admissions per micro-drain call (bounds one batch's latency;
    #: the remainder stays in order for the next tick)
    max_batch: int = 512
    #: the serve loop runs a full host cycle at least this often even
    #: while micro-drains absorb every arrival (requeue backoffs
    #: expire)
    max_cycle_gap_seconds: float = 1.0
    #: drive micro-drains from the store watch stream (a dedicated
    #: drain worker signaled per arrival) instead of the serve loop's
    #: poll tick — keeps sub-cycle latency event-bound through the
    #: loop's SlowDown backoff; bursts coalesce into one drain
    #: (the admitter's stream_demotions_total["watch_coalesced"])
    watch_driven: bool = True


@dataclass
class SLOConfig:
    """Queue-wait SLO objectives (the JAX package's obs/health.py;
    carried as data here: ROADMAP Queue A item 13).

    The SLI is time-to-admit: an admission is good when its
    creation→quota-reservation wait is within the threshold; alerts
    use multi-window burn rates over the fast/slow windows.
    """

    #: fraction of admissions that must land within the threshold
    queue_wait_target: float = 0.99
    #: "good" admission bound, seconds from creation to quota reserve
    queue_wait_threshold_seconds: float = 300.0
    #: fast burn window (catches live regressions)
    fast_window_seconds: float = 300.0
    #: slow burn window (suppresses blips)
    slow_window_seconds: float = 3600.0
    #: alert fires when BOTH windows burn above this; clears when the
    #: fast window recovers
    burn_rate_threshold: float = 6.0
    #: starvation watchdog: oldest-pending age per CQ above this is
    #: flagged starved regardless of burn rates
    starvation_threshold_seconds: float = 1800.0
    #: webhook URL POSTed on every burn-rate alert fire/clear
    #: transition (obs/health.py WebhookSink; delivery failures are
    #: counted, never raised); None disables the config-owned sink
    alert_webhook_url: Optional[str] = None
    #: per-delivery timeout bounding how long a dead receiver can
    #: stall one SLO evaluation
    alert_webhook_timeout_seconds: float = 2.0

    def __post_init__(self) -> None:
        if self.alert_webhook_url is not None:
            raise NotImplementedError(
                "SLOConfig.alert_webhook_url: the port sends no SLO "
                "alerts yet, ROADMAP Queue A item 13")


@dataclass
class DevTelConfig:
    """Device telemetry collector (the JAX package's obs/devtel.py;
    carried as data here: ROADMAP Queue A item 13).

    Off by default: every engine hook gates on ``enabled`` with a
    cheap attribute read, the bench telemetry scenario's overhead
    contract (devtel_overhead_pct <= 2)."""

    #: master switch for the collector
    enabled: bool = False
    #: first-call compile detection per (kernel, arm, shape bucket);
    #: replaces the router's one-shot compile-tainted warm set
    compile_accounting: bool = True
    #: unified solver_transfer_bytes_total{direction,arm,tenant} family
    transfer_ledger: bool = True
    #: per-drain HBM watermark gauges (memory_stats() where available,
    #: resident-problem byte bookkeeping as the portable fallback)
    hbm_watermarks: bool = True
    #: tail-based deep capture on SLO burn / phase-regression triggers
    capture_enabled: bool = False
    #: artifact directory; None defaults beside the checkpoints
    #: (persistence.dir) when persistence is configured
    capture_dir: Optional[str] = None
    #: capture session budget, seconds (finished by the drain poll)
    capture_max_seconds: float = 5.0
    #: CooldownPolicy window between capture STARTS
    capture_cooldown_seconds: float = 300.0
    #: bracket captures with a real jax.profiler trace (off by
    #: default: the marker artifact alone is cheap and test-safe)
    capture_use_profiler: bool = False

    def __post_init__(self) -> None:
        for name in ("enabled", "capture_enabled"):
            if getattr(self, name):
                raise NotImplementedError(
                    f"DevTelConfig.{name}: the port has no device "
                    f"telemetry yet, ROADMAP Queue A item 13")


@dataclass
class ObservabilityConfig:
    """Cluster health layer switches (the JAX package's obs/; carried as
    data here: ROADMAP Queue A item 13):
    flight recorder, cycle ledger, histogram exemplars, SLO engine,
    device telemetry."""

    #: decision flight recorder master switch
    recorder_enabled: bool = True
    #: per-cycle ledger rows (obs/ledger.py)
    ledger_enabled: bool = True
    #: ledger ring capacity (newest rows kept)
    ledger_max_cycles: int = 4096
    #: exemplars on the wait-time histograms (OpenMetrics exposition)
    exemplars: bool = True
    #: queue-wait SLI feeding + burn-rate alerting
    slo_enabled: bool = True
    slo: SLOConfig = field(default_factory=SLOConfig)
    devtel: DevTelConfig = field(default_factory=DevTelConfig)


@dataclass
class Configuration:
    """Reference parity: configuration_types.go Configuration."""

    namespace: str = "kueue-system"
    manage_jobs_without_queue_name: bool = False
    #: namespaces whose jobs are managed even without a queue name
    managed_jobs_namespace_selector: Optional[dict[str, str]] = None
    wait_for_pods_ready: Optional[WaitForPodsReady] = None
    #: enabled job-framework integrations (reference: Integrations.Frameworks)
    integrations: list[str] = field(
        default_factory=lambda: ["batch/job"])
    external_frameworks: list[str] = field(default_factory=list)
    fair_sharing: FairSharingConfig = field(default_factory=FairSharingConfig)
    admission_fair_sharing: Optional[AdmissionFairSharingConfig] = None
    resources: ResourcesConfig = field(default_factory=ResourcesConfig)
    object_retention_policies: Optional[ObjectRetentionPolicies] = None
    multikueue: MultiKueueConfig = field(default_factory=MultiKueueConfig)
    solver: SolverBackendConfig = field(default_factory=SolverBackendConfig)
    federation: FederationConfig = field(default_factory=FederationConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    streaming: StreamingConfig = field(default_factory=StreamingConfig)
    simulator: SimulatorConfig = field(default_factory=SimulatorConfig)
    persistence: PersistenceConfig = field(
        default_factory=PersistenceConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    feature_gates: dict[str, bool] = field(default_factory=dict)
    #: TLS options for the HTTP servers (reference: Configuration.TLS,
    #: applied in config.go:182-190 under the TLSOptions gate)
    tls: Optional["TLSOptions"] = None


_REQUEUING_TIMESTAMPS = {RequeuingTimestamp.EVICTION, RequeuingTimestamp.CREATION}
_TRANSFORM_STRATEGIES = {"Retain", "Replace"}
_FS_STRATEGIES = {"LessThanOrEqualToFinalShare", "LessThanInitialShare"}
_DISPATCHERS = {"AllAtOnce", "Incremental", "WhatIf"}


def validate(cfg: Configuration) -> list[str]:
    """Reference parity: pkg/config validation — returns a list of errors."""
    errs: list[str] = []
    wfpr = cfg.wait_for_pods_ready
    if wfpr is not None and wfpr.enable:
        if wfpr.timeout_seconds <= 0:
            errs.append("waitForPodsReady.timeout must be > 0")
        rs = wfpr.requeuing_strategy
        if rs.timestamp not in _REQUEUING_TIMESTAMPS:
            errs.append(f"waitForPodsReady.requeuingStrategy.timestamp "
                        f"{rs.timestamp!r} not in {sorted(_REQUEUING_TIMESTAMPS)}")
        if rs.backoff_limit_count is not None and rs.backoff_limit_count < 0:
            errs.append("requeuingStrategy.backoffLimitCount must be >= 0")
        if rs.backoff_base_seconds < 0:
            errs.append("requeuingStrategy.backoffBaseSeconds must be >= 0")
    for t in cfg.resources.transformations:
        if t.strategy not in _TRANSFORM_STRATEGIES:
            errs.append(f"resource transformation {t.input!r}: strategy "
                        f"{t.strategy!r} not in {sorted(_TRANSFORM_STRATEGIES)}")
    seen_inputs: set[str] = set()
    for t in cfg.resources.transformations:
        if t.input in seen_inputs:
            errs.append(f"duplicate resource transformation for {t.input!r}")
        seen_inputs.add(t.input)
    for s in cfg.fair_sharing.preemption_strategies:
        if s not in _FS_STRATEGIES:
            errs.append(f"fairSharing.preemptionStrategies: unknown {s!r}")
    if cfg.multikueue.dispatcher_name not in _DISPATCHERS:
        errs.append(f"multiKueue.dispatcherName {cfg.multikueue.dispatcher_name!r} "
                    f"not in {sorted(_DISPATCHERS)}")
    sv = cfg.solver
    if sv.timeout_seconds <= 0:
        errs.append("solver.timeout must be > 0")
    if sv.max_retries < 0:
        errs.append("solver.maxRetries must be >= 0")
    if sv.retry_backoff_base_seconds < 0:
        errs.append("solver.retryBackoffBase must be >= 0")
    if sv.retry_backoff_max_seconds < 0:
        errs.append("solver.retryBackoffMax must be >= 0")
    if sv.max_frame_bytes <= 0:
        errs.append("solver.maxFrameBytes must be > 0")
    if sv.breaker_failure_threshold < 1:
        errs.append("solver.breakerFailureThreshold must be >= 1")
    if sv.breaker_cooldown_seconds < 0:
        errs.append("solver.breakerCooldown must be >= 0")
    if sv.mesh is not None:
        m = str(sv.mesh).strip().lower()
        known = {"auto", "on", "off", "none", "true", "false", "disabled"}
        if m not in known and not m.isdigit():
            errs.append(f"solver.mesh {sv.mesh!r} must be 'auto', 'off', "
                        "or a non-negative device count")
    if sv.coordinator_processes < 1:
        errs.append("solver.coordinatorProcesses must be >= 1")
    elif not (0 <= sv.coordinator_process_id < sv.coordinator_processes):
        errs.append("solver.coordinatorProcessId must be in "
                    "[0, coordinatorProcesses)")
    if sv.coordinator_processes > 1 and not sv.coordinator_address:
        errs.append("solver.coordinatorAddress is required when "
                    "coordinatorProcesses > 1")
    if sv.relax_min_workloads < 0:
        errs.append("solver.relaxMinWorkloads must be >= 0")
    if sv.relax_audit_every < 0:
        errs.append("solver.relaxAuditEvery must be >= 0")
    if sv.relax_iters < 1:
        errs.append("solver.relaxIters must be >= 1")
    if not (0.0 < sv.relax_support_threshold < 1.0):
        errs.append("solver.relaxSupportThreshold must be in (0, 1)")
    if sv.relax_retry_cooldown_seconds < 0:
        errs.append("solver.relaxRetryCooldown must be >= 0")
    if sv.max_sessions is not None and sv.max_sessions < 1:
        errs.append("solver.maxSessions must be >= 1")
    fed = cfg.federation
    if fed.default_weight <= 0:
        errs.append("federation.defaultWeight must be > 0")
    for t, w in fed.tenant_weights.items():
        if w <= 0:
            errs.append(f"federation.tenantWeights[{t!r}] must be > 0")
    if fed.quantum_seconds <= 0:
        errs.append("federation.quantum must be > 0")
    if fed.max_queued < 1:
        errs.append("federation.maxQueued must be >= 1")
    if fed.max_credit_quanta <= 0:
        errs.append("federation.maxCreditQuanta must be > 0")
    res = cfg.resilience
    if res.history_limit < 1:
        errs.append("resilience.historyLimit must be >= 1")
    if res.wal_restore_cooldown_seconds < 0:
        errs.append("resilience.walRestoreCooldown must be >= 0")
    sim = cfg.simulator
    if sim.max_scenarios < 1:
        errs.append("simulator.maxScenarios must be >= 1")
    if sim.parity_scenarios < 0:
        errs.append("simulator.parityScenarios must be >= 0")
    if sim.min_batch_for_mesh < 1:
        errs.append("simulator.minBatchForMesh must be >= 1")
    if sim.min_batch_for_bucketing < 1:
        errs.append("simulator.minBatchForBucketing must be >= 1")
    if sim.mesh is not None:
        m = str(sim.mesh).strip().lower()
        known = {"auto", "on", "off", "none", "true", "false", "disabled"}
        if m not in known and not m.isdigit():
            errs.append(f"simulator.mesh {sim.mesh!r} must be 'auto', "
                        "'off', or a non-negative device count")
    if sim.lane_budget_mb < 1:
        errs.append("simulator.laneBudgetMB must be >= 1")
    if sim.full_sweep_max < 1:
        errs.append("simulator.fullSweepMax must be >= 1")
    if sim.relax_iters < 1:
        errs.append("simulator.relaxIters must be >= 1")
    st = cfg.streaming
    if st.max_batch < 1:
        errs.append("streaming.maxBatch must be >= 1")
    if st.max_cycle_gap_seconds <= 0:
        errs.append("streaming.maxCycleGap must be > 0")
    per = cfg.persistence
    if per.enabled and not per.dir:
        errs.append("persistence.dir is required when persistence is "
                    "enabled")
    if per.full_checkpoint_every < 1:
        errs.append("persistence.fullCheckpointEvery must be >= 1")
    if per.fsync not in ("always", "batch", "off"):
        errs.append(f"persistence.fsync {per.fsync!r} must be "
                    "'always', 'batch', or 'off'")
    if per.batch_records < 1:
        errs.append("persistence.batchRecords must be >= 1")
    if per.checkpoint_interval_records < 1:
        errs.append("persistence.checkpointIntervalRecords must be >= 1")
    if per.checkpoint_interval_seconds < 0:
        errs.append("persistence.checkpointInterval must be >= 0")
    if per.keep_checkpoints < 1:
        errs.append("persistence.keepCheckpoints must be >= 1")
    if per.audit_interval_seconds < 0:
        errs.append("persistence.auditInterval must be >= 0")
    ob = cfg.observability
    if ob.ledger_max_cycles < 1:
        errs.append("observability.ledgerMaxCycles must be >= 1")
    slo = ob.slo
    if not (0.0 < slo.queue_wait_target <= 1.0):
        errs.append("observability.slo.queueWaitTarget must be in "
                    "(0, 1]")
    if slo.queue_wait_threshold_seconds <= 0:
        errs.append("observability.slo.queueWaitThreshold must be > 0")
    if slo.fast_window_seconds <= 0:
        errs.append("observability.slo.fastWindow must be > 0")
    if slo.slow_window_seconds < slo.fast_window_seconds:
        errs.append("observability.slo.slowWindow must be >= fastWindow")
    if slo.burn_rate_threshold <= 0:
        errs.append("observability.slo.burnRateThreshold must be > 0")
    if slo.starvation_threshold_seconds < 0:
        errs.append("observability.slo.starvationThreshold must be "
                    ">= 0")
    if slo.alert_webhook_timeout_seconds <= 0:
        errs.append("observability.slo.alertWebhookTimeout must be "
                    "> 0")
    dtl = ob.devtel
    if dtl.capture_max_seconds <= 0:
        errs.append("observability.devtel.captureMaxSeconds must be "
                    "> 0")
    if dtl.capture_cooldown_seconds < 0:
        errs.append("observability.devtel.captureCooldownSeconds must "
                    "be >= 0")
    afs = cfg.admission_fair_sharing
    if afs is not None:
        if afs.usage_half_life_time_seconds < 0:
            errs.append("admissionFairSharing.usageHalfLifeTime must be >= 0")
        for r, w in afs.resource_weights.items():
            if w < 0:
                errs.append(f"admissionFairSharing.resourceWeights[{r!r}] "
                            "must be >= 0")
    if cfg.tls is not None:
        from kueue_oss_tpu_torch import features
        from kueue_oss_tpu_torch.util.tlsconfig import (
            TLSOptionsError,
            parse_tls_options,
        )

        if features.enabled("TLSOptions"):
            try:
                parse_tls_options(cfg.tls)
            except TLSOptionsError as e:
                errs.append(f"tls: {e}")
    return errs


def apply_feature_gates(cfg: Configuration) -> None:
    """Apply Configuration.featureGates to the live gate registry
    (reference: cmd/kueue/main.go:157-172 merges config + flag gates).
    The port's registry holds the gates it reads: a gate it does not
    know raises ``features.UnknownFeatureGate``, as the JAX registry
    does for its own."""
    from kueue_oss_tpu_torch import features

    if cfg.feature_gates:
        features.set_gates(cfg.feature_gates)


def _build(cls, data: dict, mapping: dict):
    kwargs = {}
    for yaml_key, (attr, conv) in mapping.items():
        if yaml_key in data:
            v = data[yaml_key]
            kwargs[attr] = conv(v) if conv else v
    return cls(**kwargs)


def load(data: Optional[dict] = None) -> Configuration:
    """Build a Configuration from a plain (YAML-decoded) dict.

    Reference parity: pkg/config.Load — unknown keys are ignored (the
    reference tolerates forward-compat fields), camelCase keys follow the
    reference API.
    """
    data = data or {}

    def conv_rs(d: dict) -> RequeuingStrategy:
        return _build(RequeuingStrategy, d, {
            "timestamp": ("timestamp", None),
            "backoffLimitCount": ("backoff_limit_count", None),
            "backoffBaseSeconds": ("backoff_base_seconds", float),
            "backoffMaxSeconds": ("backoff_max_seconds", float),
        })

    def conv_wfpr(d: dict) -> WaitForPodsReady:
        return _build(WaitForPodsReady, d, {
            "enable": ("enable", None),
            "timeout": ("timeout_seconds", float),
            "recoveryTimeout": ("recovery_timeout_seconds", float),
            "blockAdmission": ("block_admission", None),
            "requeuingStrategy": ("requeuing_strategy", conv_rs),
        })

    def conv_fs(d: dict) -> FairSharingConfig:
        return _build(FairSharingConfig, d, {
            "enable": ("enable", None),
            "preemptionStrategies": ("preemption_strategies", list),
        })

    def conv_afs(d: dict) -> AdmissionFairSharingConfig:
        return _build(AdmissionFairSharingConfig, d, {
            "usageHalfLifeTime": ("usage_half_life_time_seconds", float),
            "usageSamplingInterval": ("usage_sampling_interval_seconds", float),
            "resourceWeights": ("resource_weights", dict),
        })

    def conv_transform(d: dict) -> ResourceTransformation:
        return _build(ResourceTransformation, d, {
            "input": ("input", None),
            "strategy": ("strategy", None),
            "outputs": ("outputs", dict),
        })

    def conv_resources(d: dict) -> ResourcesConfig:
        return _build(ResourcesConfig, d, {
            "excludeResourcePrefixes": ("exclude_resource_prefixes", list),
            "transformations": (
                "transformations",
                lambda ts: [conv_transform(t) for t in ts]),
            "deviceClassMappings": ("device_class_mappings", dict),
            "quotaCheckStrategy": ("quota_check_strategy", str),
        })

    def conv_retention(d: dict) -> ObjectRetentionPolicies:
        return _build(ObjectRetentionPolicies, d, {
            "finishedWorkloadRetention": (
                "finished_workload_retention_seconds", float),
            "deactivatedWorkloadRetention": (
                "deactivated_workload_retention_seconds", float),
        })

    def conv_mk(d: dict) -> MultiKueueConfig:
        return _build(MultiKueueConfig, d, {
            "gcInterval": ("gc_interval_seconds", float),
            "origin": ("origin", None),
            "workerLostTimeout": ("worker_lost_timeout_seconds", float),
            "dispatcherName": ("dispatcher_name", None),
        })

    def conv_solver(d: dict) -> SolverBackendConfig:
        return _build(SolverBackendConfig, d, {
            "socketPath": ("socket_path", None),
            "tenant": ("tenant", str),
            "maxSessions": ("max_sessions", int),
            "timeout": ("timeout_seconds", float),
            "maxRetries": ("max_retries", int),
            "retryBackoffBase": ("retry_backoff_base_seconds", float),
            "retryBackoffMax": ("retry_backoff_max_seconds", float),
            "maxFrameBytes": ("max_frame_bytes", int),
            "breakerFailureThreshold": ("breaker_failure_threshold", int),
            "breakerCooldown": ("breaker_cooldown_seconds", float),
            "sessionsEnabled": ("sessions_enabled", bool),
            "mesh": ("mesh", str),
            "coordinatorAddress": ("coordinator_address", str),
            "coordinatorProcesses": ("coordinator_processes", int),
            "coordinatorProcessId": ("coordinator_process_id", int),
            "relaxEnabled": ("relax_enabled", bool),
            "relaxMinWorkloads": ("relax_min_workloads", int),
            "relaxAuditEvery": ("relax_audit_every", int),
            "relaxIters": ("relax_iters", int),
            "relaxSupportThreshold": ("relax_support_threshold", float),
            "relaxRetryCooldown": ("relax_retry_cooldown_seconds",
                                   float),
        })

    def conv_federation(d: dict) -> FederationConfig:
        return _build(FederationConfig, d, {
            "tenantWeights": ("tenant_weights", dict),
            "defaultWeight": ("default_weight", float),
            "quantum": ("quantum_seconds", float),
            "maxQueued": ("max_queued", int),
            "maxCreditQuanta": ("max_credit_quanta", float),
        })

    def conv_persist(d: dict) -> PersistenceConfig:
        return _build(PersistenceConfig, d, {
            "enabled": ("enabled", None),
            "dir": ("dir", str),
            "fsync": ("fsync", str),
            "batchRecords": ("batch_records", int),
            "checkpointIntervalRecords": (
                "checkpoint_interval_records", int),
            "checkpointInterval": ("checkpoint_interval_seconds", float),
            "keepCheckpoints": ("keep_checkpoints", int),
            "auditInterval": ("audit_interval_seconds", float),
            "auditAutoHeal": ("audit_auto_heal", None),
            "incrementalCheckpoints": ("incremental_checkpoints", None),
            "fullCheckpointEvery": ("full_checkpoint_every", int),
            "shipTo": ("ship_to", str),
            "shipCompact": ("ship_compact", None),
        })

    def conv_resilience(d: dict) -> ResilienceConfig:
        return _build(ResilienceConfig, d, {
            "enabled": ("enabled", None),
            "historyLimit": ("history_limit", int),
            "walRestoreCooldown": ("wal_restore_cooldown_seconds",
                                   float),
        })

    def conv_streaming(d: dict) -> StreamingConfig:
        return _build(StreamingConfig, d, {
            "enabled": ("enabled", None),
            "maxBatch": ("max_batch", int),
            "maxCycleGap": ("max_cycle_gap_seconds", float),
            "watchDriven": ("watch_driven", None),
        })

    def conv_slo(d: dict) -> SLOConfig:
        return _build(SLOConfig, d, {
            "queueWaitTarget": ("queue_wait_target", float),
            "queueWaitThreshold": (
                "queue_wait_threshold_seconds", float),
            "fastWindow": ("fast_window_seconds", float),
            "slowWindow": ("slow_window_seconds", float),
            "burnRateThreshold": ("burn_rate_threshold", float),
            "starvationThreshold": (
                "starvation_threshold_seconds", float),
            "alertWebhookUrl": ("alert_webhook_url", str),
            "alertWebhookTimeout": (
                "alert_webhook_timeout_seconds", float),
        })

    def conv_devtel(d: dict) -> DevTelConfig:
        return _build(DevTelConfig, d, {
            "enabled": ("enabled", None),
            "compileAccounting": ("compile_accounting", None),
            "transferLedger": ("transfer_ledger", None),
            "hbmWatermarks": ("hbm_watermarks", None),
            "captureEnabled": ("capture_enabled", None),
            "captureDir": ("capture_dir", None),
            "captureMaxSeconds": ("capture_max_seconds", float),
            "captureCooldownSeconds": ("capture_cooldown_seconds",
                                       float),
            "captureUseProfiler": ("capture_use_profiler", None),
        })

    def conv_obs(d: dict) -> ObservabilityConfig:
        return _build(ObservabilityConfig, d, {
            "recorderEnabled": ("recorder_enabled", None),
            "ledgerEnabled": ("ledger_enabled", None),
            "ledgerMaxCycles": ("ledger_max_cycles", int),
            "exemplars": ("exemplars", None),
            "sloEnabled": ("slo_enabled", None),
            "slo": ("slo", conv_slo),
            "devtel": ("devtel", conv_devtel),
        })

    def conv_sim(d: dict) -> SimulatorConfig:
        return _build(SimulatorConfig, d, {
            "maxScenarios": ("max_scenarios", int),
            "parityScenarios": ("parity_scenarios", int),
            "padPow2": ("pad_pow2", bool),
            "mesh": ("mesh", str),
            "minBatchForMesh": ("min_batch_for_mesh", int),
            "roundBucketing": ("round_bucketing", bool),
            "minBatchForBucketing": ("min_batch_for_bucketing", int),
            "fullKernel": ("full_kernel", bool),
            "laneBudgetMB": ("lane_budget_mb", int),
            "fullSweepMax": ("full_sweep_max", int),
            "relaxIters": ("relax_iters", int),
        })

    def conv_integrations(d: dict) -> list[str]:
        return list(d.get("frameworks", []))

    def conv_tls(d: dict) -> TLSOptions:
        return _build(TLSOptions, d, {
            "minVersion": ("min_version", None),
            "cipherSuites": ("cipher_suites", list),
            "certFile": ("cert_file", None),
            "keyFile": ("key_file", None),
        })

    cfg = _build(Configuration, data, {
        "namespace": ("namespace", None),
        "manageJobsWithoutQueueName": ("manage_jobs_without_queue_name", None),
        "managedJobsNamespaceSelector": ("managed_jobs_namespace_selector", None),
        "waitForPodsReady": ("wait_for_pods_ready", conv_wfpr),
        "fairSharing": ("fair_sharing", conv_fs),
        "admissionFairSharing": ("admission_fair_sharing", conv_afs),
        "resources": ("resources", conv_resources),
        "objectRetentionPolicies": ("object_retention_policies", conv_retention),
        "multiKueue": ("multikueue", conv_mk),
        "solver": ("solver", conv_solver),
        "federation": ("federation", conv_federation),
        "resilience": ("resilience", conv_resilience),
        "streaming": ("streaming", conv_streaming),
        "simulator": ("simulator", conv_sim),
        "persistence": ("persistence", conv_persist),
        "observability": ("observability", conv_obs),
        "featureGates": ("feature_gates", dict),
        "tls": ("tls", conv_tls),
    })
    if "integrations" in data:
        cfg.integrations = conv_integrations(data["integrations"])
        cfg.external_frameworks = list(
            data["integrations"].get("externalFrameworks", []))
    return cfg


def apply_resource_transformations(
        requests: dict[str, int], cfg: ResourcesConfig) -> dict[str, int]:
    """Apply exclude-prefixes then transformations to a request map.

    Reference parity: pkg/workload/resources.go — transformations run on the
    effective podset requests before quota accounting.
    """
    out: dict[str, int] = {}
    transforms = {t.input: t for t in cfg.transformations}
    for r, q in requests.items():
        if any(r.startswith(p) for p in cfg.exclude_resource_prefixes):
            continue
        t = transforms.get(r)
        if t is None:
            out[r] = out.get(r, 0) + q
            continue
        if t.strategy == "Retain":
            out[r] = out.get(r, 0) + q
        for target, weight in t.outputs.items():
            out[target] = out.get(target, 0) + int(q * weight)
    return out

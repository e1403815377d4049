"""Framework configuration.

Copies of ``StreamingConfig``, ``SimulatorConfig`` and
``SolverBackendConfig`` from ``kueue_oss_tpu/config/configuration.py``:
the knobs of ``Scheduler(streaming=StreamingConfig(...))``, of the
what-if engine's lean sweep and of ``Scheduler(solver_config=...)``. The
rest of the configuration (the Configuration tree and its loader, SLO
and persistence settings) waits for ROADMAP Queue A item 10, with the
rest of the JAX package's entry points.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional


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

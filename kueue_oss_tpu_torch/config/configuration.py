"""Framework configuration.

Copies of ``StreamingConfig`` and ``SimulatorConfig`` from
``kueue_oss_tpu/config/configuration.py``: the knobs of
``Scheduler(streaming=StreamingConfig(...))`` and of the what-if
engine's lean sweep. The rest of the configuration (the Configuration
tree, the solver backend, SLO and persistence settings) waits for
ROADMAP Queue A items 6 and 8.
"""

from __future__ import annotations

from dataclasses import dataclass


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
    simulator; these bound the batched scenario sweeps. Only the lean
    sweep's fields are copied: the FULL sweep's lane budget, sweep cap
    and relax iterations wait for ROADMAP Queue A item 7b.
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
    #: route sweeps through the FULL preemption kernel (ROADMAP Queue A
    #: item 7b); only False runs here
    full_kernel: bool = False

    def __post_init__(self) -> None:
        if str(self.mesh or "off") != "off":
            raise NotImplementedError(
                "SimulatorConfig.mesh: the scenario-axis mesh is ROADMAP "
                "Queue A item 9")
        if self.full_kernel:
            raise NotImplementedError(
                "SimulatorConfig.full_kernel: the FULL what-if sweep is "
                "ROADMAP Queue A item 7b")

"""Framework configuration.

A copy of ``StreamingConfig`` from
``kueue_oss_tpu/config/configuration.py``: the knobs of
``Scheduler(streaming=StreamingConfig(...))``. The rest of the
configuration (the Configuration tree, the solver backend, SLO and
persistence settings) waits for ROADMAP Queue A items 6 and 8.
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

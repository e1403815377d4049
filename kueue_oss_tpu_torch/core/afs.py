"""Admission fair sharing (KEP-4136).

A copy of ``kueue_oss_tpu/core/afs.py`` (reference: pkg/cache/queue/afs
and pkg/util/admissionfairsharing) with the
``AdmissionFairSharingConfig`` it reads
(``kueue_oss_tpu/config/configuration.py``; the port has no ``config``
package). LocalQueues accumulate historical resource usage that decays
with a configurable half-life; within a ClusterQueue whose
admissionScope is UsageBasedAdmissionFairSharing, pending workloads
from lighter-usage LocalQueues are admitted first. An admission charges
an entry penalty equal to its usage at once (afs/entry_penalties.go;
here the penalty is the sample).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

#: resources counted when no explicit weights are configured
_DEFAULT_WEIGHT = 1.0


@dataclass
class AdmissionFairSharingConfig:
    """Reference parity: configuration_types.go AdmissionFairSharing."""

    usage_half_life_time_seconds: float = 300.0
    usage_sampling_interval_seconds: float = 10.0
    resource_weights: dict[str, float] = field(default_factory=dict)


class AfsManager:
    """Decayed per-LocalQueue usage store."""

    def __init__(self, config: Optional[AdmissionFairSharingConfig] = None,
                 lq_weights: Optional[dict[str, float]] = None) -> None:
        self.config = config or AdmissionFairSharingConfig()
        #: lq key -> (resource -> decayed quantity, last decay timestamp)
        self._usage: dict[str, tuple[dict[str, float], float]] = {}
        #: optional per-LQ fair-sharing weight (localqueue fairSharing.weight)
        self.lq_weights = lq_weights or {}

    def _decay_factor(self, dt: float) -> float:
        hl = self.config.usage_half_life_time_seconds
        if hl <= 0:
            return 0.0
        return math.pow(0.5, max(dt, 0.0) / hl)

    def _decayed(self, lq_key: str, now: float) -> dict[str, float]:
        entry = self._usage.get(lq_key)
        if entry is None:
            return {}
        usage, t0 = entry
        f = self._decay_factor(now - t0)
        return {r: q * f for r, q in usage.items()}

    def record_admission(self, lq_key: str, usage: dict[str, int],
                         now: float) -> None:
        """Charge an admitted workload's usage to its LocalQueue (entry
        penalty and sampled usage in one step)."""
        current = self._decayed(lq_key, now)
        for r, q in usage.items():
            current[r] = current.get(r, 0.0) + float(q)
        self._usage[lq_key] = (current, now)

    def entry_penalty(self, lq_key: str, usage: dict[str, float]) -> float:
        """The penalty an admission of ``usage`` charges its LocalQueue
        (afs/entry_penalties.go): the resource-weighted sum divided by
        the LQ's fair-sharing weight, infinite for a weight of 0."""
        lq_w = self.lq_weights.get(lq_key, 1.0)
        total = self._weighted_sum(usage)
        return total / lq_w if lq_w > 0 else math.inf

    def weighted_usage(self, lq_key: str, now: float) -> float:
        """Scalarized decayed usage (admissionfairsharing.go): as
        ``entry_penalty``, but 0 for an unused LQ of weight 0."""
        usage = self._decayed(lq_key, now)
        if self.lq_weights.get(lq_key, 1.0) <= 0:
            return math.inf if self._weighted_sum(usage) > 0 else 0.0
        return self.entry_penalty(lq_key, usage)

    def ordering_key(self, lq_key: str, now: float) -> float:
        """The host cycle's AFS pop order (the queue manager's head of an
        AFS ClusterQueue is the entry with the lowest key)."""
        return self.weighted_usage(lq_key, now)

    def _weighted_sum(self, usage: dict[str, float]) -> float:
        weights = self.config.resource_weights
        total = 0.0
        for r, q in usage.items():
            total += weights.get(r, _DEFAULT_WEIGHT) * q
        return total

"""Feature-gate defaults read by the port.

The JAX package keeps a mutable gate registry
(``kueue_oss_tpu/features``); the port reads the same gates at their
reference defaults and has no override path. The JAX package's
process-wide requests config (``core/workload_info.py``: LimitRange
defaults, resource transformations, QuotaCheckStrategy=IgnoreUndeclared)
is likewise at its default, empty, and so is not read at all.
"""

from __future__ import annotations

_DEFAULTS: dict[str, bool] = {
    "LendingLimit": True,              # core/quota.py local quota
    "HierarchicalCohorts": True,       # core/store.py cohort parent edges
    "ReclaimablePods": True,           # core/workload_info.py totals
    "TopologyAwareScheduling": True,   # core/snapshot.py TAS snapshots
    "TASBalancedPlacement": False,     # solver/tas_engine.py shape gate
    "ConcurrentAdmission": False,      # core/queue_manager.py CA parents
    "PriorityBoost": False,            # core/workload_info.py priority
    "SchedulingEquivalenceHashing": True,  # solver/tensors.py NoFit classes
    "SchedulerTimestampPreemptionBuffer": False,  # solver wl_ts_buf ranks
    # read by solver/fair_kernels.py
    "PrioritySortingWithinCohort": True,      # entry tournament priority key
    "FairSharingPreemptWithinNominal": True,  # within-nominal bypass
    "FairSharingPrioritizeNonBorrowing": True,  # entry tournament step 1
    # read by the host scheduler cycle (scheduler/)
    "PartialAdmission": True,          # podset reduction
    "FlavorFungibility": True,         # flavor_assigner custom policy
    "AdmissionFairSharing": True,      # queue_manager AFS ordering key
}


def enabled(name: str) -> bool:
    """Default of a registered gate; unknown names raise KeyError."""
    return _DEFAULTS[name]

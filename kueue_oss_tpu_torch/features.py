"""Feature gates read by the port.

A copy of the JAX package's gate registry (``kueue_oss_tpu/features``)
cut to the gates the port reads, at their reference defaults.
``set_gates`` overrides gates process-wide and ``reset`` restores the
defaults, with the JAX package's signatures, so tests and chip_smoke.py
can run the gated modes (the TAS placement's balanced, multi-layer and
device fill-in-counts modes, the failure controller's fail-fast, the
MultiKueue hub's race rules, QuotaCheckStrategy=IgnoreUndeclared, the
Configuration's TLS options).
"""

from __future__ import annotations

import threading

_DEFAULTS: dict[str, bool] = {
    "LendingLimit": True,              # core/quota.py local quota
    "HierarchicalCohorts": True,       # core/store.py cohort parent edges
    "ReclaimablePods": True,           # core/workload_info.py totals
    "TopologyAwareScheduling": True,   # core/snapshot.py TAS snapshots
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
    "SchedulerLongRequeueInterval": False,  # scheduler.serve requeue sweep
    "AdmissionFairSharing": True,      # queue_manager AFS ordering key
    # topology-aware scheduling (tas/snapshot.py)
    "TASProfileMixed": True,           # LeastFreeCapacity for unconstrained
    "TASFailedNodeReplacement": True,  # replacement path
    # controllers/failure_recovery.py: evict at once when no replacement
    "TASFailedNodeReplacementFailFast": False,
    "TASBalancedPlacement": False,     # balanced algorithm; tas_engine gate
    "TASMultiLayerTopology": False,    # nested slice layers
    # phase-1 fill-in counts on the device (_device_fill), phase-2
    # tie-breaks on the host
    "TASDeviceFillCounts": False,
    # the MultiKueue hub (multikueue/controller.py)
    "MultiKueue": True,                # controller sync
    "MultiKueueWaitForWorkloadAdmitted": True,  # race won by Admitted
    "MultiKueueRedoAdmissionOnEvictionInWorker": True,  # _sync_winner
    # Resources.quotaCheckStrategy=IgnoreUndeclared honored (GA)
    "QuotaCheckStrategy": True,        # flavor_assigner + solver export
    # TLS options validated by config.validate (beta, on)
    "TLSOptions": True,                # util/tlsconfig parse_tls_options
    # the metrics registry (metrics/__init__.py)
    "LocalQueueMetrics": True,         # local_queue_* metric series
    "CustomMetricLabels": False,       # metrics custom label resolution
}

_lock = threading.Lock()
_overrides: dict[str, bool] = {}


class UnknownFeatureGate(KeyError):
    pass


def enabled(name: str) -> bool:
    """A registered gate's value; unknown names raise."""
    if name not in _DEFAULTS:
        raise UnknownFeatureGate(name)
    v = _overrides.get(name)
    return _DEFAULTS[name] if v is None else v


def set_gates(gates: dict[str, bool]) -> None:
    """Apply overrides (Configuration.featureGates / --feature-gates)."""
    unknown = sorted(set(gates) - set(_DEFAULTS))
    if unknown:
        raise UnknownFeatureGate(", ".join(unknown))
    with _lock:
        _overrides.update(gates)


def reset() -> None:
    """Restore defaults (test isolation)."""
    with _lock:
        _overrides.clear()


def all_gates() -> dict[str, bool]:
    """Every registered gate's current value."""
    with _lock:
        return {n: _overrides.get(n, d) for n, d in _DEFAULTS.items()}

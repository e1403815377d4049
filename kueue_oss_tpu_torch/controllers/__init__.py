"""Controllers of the port (``kueue_oss_tpu/controllers``): the workload
reconciler's admission-check path and the node-failure recovery that
re-places TAS workloads from outside the scheduler. The JAX package's
other reconcilers (ClusterQueue, LocalQueue, Cohort, ResourceFlavor,
AdmissionCheck status, priority classes and concurrent admission) are
cut: nothing in the port reads their status objects."""

from kueue_oss_tpu_torch.controllers.failure_recovery import (
    NodeFailureController,
)
from kueue_oss_tpu_torch.controllers.workload_controller import (
    EvictionReason,
    WorkloadReconciler,
)

__all__ = ["EvictionReason", "NodeFailureController", "WorkloadReconciler"]

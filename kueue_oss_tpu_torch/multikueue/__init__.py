"""MultiKueue multi-cluster dispatch (KEP-693), a copy of
``kueue_oss_tpu/multikueue`` as far as a hub with in-process workers
drives it: the hub mirrors quota-reserved workloads to nominated
workers, races their admissions (the first worker to admit wins, the
rest are cleaned up), copies worker status back, and re-dispatches
when a worker is lost past a timeout. Dispatchers: AllAtOnce,
Incremental, and WhatIf (one batched what-if drain prices every
candidate, ``sim/dispatch.py``)."""

from kueue_oss_tpu_torch.multikueue.cluster import (
    MultiKueueCluster,
    WorkerEnvironment,
)
from kueue_oss_tpu_torch.multikueue.controller import (
    MULTIKUEUE_CONTROLLER_NAME,
    MultiKueueController,
)
from kueue_oss_tpu_torch.multikueue.dispatcher import (
    DISPATCHER_ALL_AT_ONCE,
    DISPATCHER_INCREMENTAL,
    DISPATCHER_WHAT_IF,
    AllAtOnceDispatcher,
    IncrementalDispatcher,
    WhatIfDispatcher,
)

__all__ = [
    "MultiKueueCluster",
    "WorkerEnvironment",
    "AllAtOnceDispatcher",
    "IncrementalDispatcher",
    "WhatIfDispatcher",
    "DISPATCHER_ALL_AT_ONCE",
    "DISPATCHER_INCREMENTAL",
    "DISPATCHER_WHAT_IF",
    "MULTIKUEUE_CONTROLLER_NAME",
    "MultiKueueController",
]

"""Worker-cluster handles.

A copy of ``kueue_oss_tpu/multikueue/cluster.py`` (reference:
pkg/controller/admissionchecks/multikueue/multikueuecluster.go). A
worker is an in-process environment (store, queues, host scheduler);
``active`` models connectivity and ``last_seen`` drives the
worker-lost timeout (controllers.go:111). Cut from the copy: the
kubeconfig sources and their gates (``KubeConfigSource``), the socket
worker (``multikueue/worker.py``) and the external-framework job
objects: every worker of the port is in process.
"""

from __future__ import annotations

from dataclasses import dataclass

from kueue_oss_tpu_torch.core.queue_manager import QueueManager
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.scheduler.scheduler import Scheduler


class WorkerEnvironment:
    """A self-contained worker cluster: store, queues and a host-only
    scheduler. ``device`` is where that scheduler's TAS fill-in counts
    run under TASDeviceFillCounts (nothing else of a worker touches a
    device)."""

    def __init__(self, name: str, store: Store = None,
                 device="cuda") -> None:
        self.name = name
        self.store = store or Store()
        self.queues = QueueManager(self.store)
        self.scheduler = Scheduler(self.store, self.queues, device=device)

    def run_cycle(self, now: float):
        """One worker scheduling cycle (the caller advances workers)."""
        return self.scheduler.schedule(now)


@dataclass
class MultiKueueCluster:
    """MultiKueueCluster CRD analog: names a worker and its connection."""

    name: str
    environment: WorkerEnvironment
    #: connectivity (reference: cluster Active condition)
    active: bool = True
    last_seen: float = 0.0

    def mark_seen(self, now: float) -> None:
        self.last_seen = now

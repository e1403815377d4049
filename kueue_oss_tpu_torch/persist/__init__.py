"""Durable control plane: write-ahead log, checkpoints, recovery, auditor.

A copy of ``kueue_oss_tpu/persist/``. A durability directory written by
either package recovers in the other to the same bytes (``codec``).

The reference Kueue survives controller restarts because the apiserver
(etcd) is its durable store — the cache and queues rebuild from watches
on start. This reproduction keeps the whole control plane in process
memory, so until this subsystem a crash lost every admission decision
ever made. ``persist`` closes that gap (docs/DURABILITY.md):

- :mod:`codec` — canonical (byte-stable) serialization of every API
  object and of a whole :class:`~kueue_oss_tpu_torch.core.store.Store`;
- :mod:`wal` — a CRC-framed, fsynced write-ahead log fed by
  ``Store._emit`` events plus scheduler decision intents;
- :mod:`checkpoint` — atomic periodic checkpoints (tmp file +
  ``os.replace`` + directory fsync) with WAL truncation on success;
- :mod:`manager` — :class:`PersistenceManager`, the wiring: store
  watch -> WAL, intent fencing, checkpoint cadence, and recovery
  (newest valid checkpoint + replay of the WAL suffix, tolerant of a
  torn tail);
- :mod:`auditor` — :class:`InvariantAuditor`, recomputing per-CQ usage
  and cohort subtree quota from admitted workloads via the
  ``core/quota.py`` formulas and diffing against store accounting;
- :mod:`hooks` — named crash points for the chaos harness
  (``kueue_oss_tpu_torch/chaos`` ``CrashPointInjector`` +
  ``persist/crashtest.py`` subprocess harness);
- :mod:`shipping` — :class:`LogShipper` (continuous WAL tail +
  sealed-segment + checkpoint shipping with per-key compaction) and
  :class:`WarmStandby` (follower replay; failover = the unsynced
  tail).
"""

from kueue_oss_tpu_torch.persist.auditor import InvariantAuditor, Violation
from kueue_oss_tpu_torch.persist.checkpoint import fsync_dir
from kueue_oss_tpu_torch.persist.codec import (
    CutFieldError,
    canonical_dump,
    from_dict,
    store_from_dict,
    store_to_dict,
    to_dict,
)
from kueue_oss_tpu_torch.persist.manager import (
    PersistenceManager,
    RecoveryResult,
    apply_event,
    materialize_chain,
)
from kueue_oss_tpu_torch.persist.shipping import (
    LogShipper,
    WarmStandby,
    compact_records,
)
from kueue_oss_tpu_torch.persist.wal import WriteAheadLog, replay_wal

__all__ = [
    "CutFieldError",
    "InvariantAuditor",
    "LogShipper",
    "PersistenceManager",
    "RecoveryResult",
    "Violation",
    "WarmStandby",
    "WriteAheadLog",
    "apply_event",
    "canonical_dump",
    "compact_records",
    "from_dict",
    "fsync_dir",
    "materialize_chain",
    "replay_wal",
    "store_from_dict",
    "store_to_dict",
    "to_dict",
]

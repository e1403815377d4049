"""PersistenceManager: WAL wiring, checkpoints, recovery.

A copy of ``kueue_oss_tpu/persist/manager.py``, restoring the decision
journal and the cycle ledger into the port's ``obs/``.

One manager owns one durability directory:

    <dir>/checkpoint-<n>.ckpt   atomic snapshots (checkpoint.py)
    <dir>/wal-<n>.log           records appended AFTER checkpoint n

``attach(store)`` subscribes to ``Store._emit``: every mutation event
becomes one WAL ``event`` record carrying the full post-mutation
object. Scheduler decision paths additionally call ``intent()`` BEFORE
mutating — the intent is fsynced (a write barrier) and carries the
workload's pre-mutation resource_version, so recovery can verify which
decisions applied (a following event at rv+1) and which the crash ate
(the scheduler simply redoes those from the recovered state).

Checkpoints rotate the WAL: sync the active segment, write
checkpoint n+1 atomically, open wal-(n+1).log, then delete segments
and checkpoints the retention window no longer needs. A crash at any
point leaves a recoverable prefix: an unpublished checkpoint temp file
is never considered, and an unrotated WAL still pairs with the
previous checkpoint.

Recovery = newest valid checkpoint + replay of its WAL segment,
tolerant of a torn tail. Replay applies events RAW (no version bumps,
no metric side effects) with a resource-version guard so records that
raced on the emit path converge to the newest state. With
``emit=True`` every applied object is re-emitted through the store's
watch stream, so a promoted replica's watch-driven caches
(QueueManager heaps) warm during the replay itself.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Optional

from kueue_oss_tpu_torch import metrics
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.persist import checkpoint as ckpt
from kueue_oss_tpu_torch.persist import codec, hooks
from kueue_oss_tpu_torch.persist.wal import FSYNC_BATCH, WriteAheadLog, replay_wal

_SEG = re.compile(r"^wal-(\d+)\.log$")
_OBS = re.compile(r"^(journal|ledger)-(\d+)\.jsonl$")


def _segment_path(dir_path: str, seg: int) -> str:
    return os.path.join(dir_path, f"wal-{seg:08d}.log")


def _obs_path(dir_path: str, kind: str, ckpt_id: int) -> str:
    return os.path.join(dir_path, f"{kind}-{ckpt_id:08d}.jsonl")


def apply_event(store: Store, verb: str, kind: str, obj_dict: dict,
                emit: bool = False) -> bool:
    """Apply one WAL event record to the store, raw.

    Objects land verbatim (their recorded post-mutation state). For
    workloads, a record older than the stored resource_version is
    skipped: watchers run outside the store lock, so two racing writes
    can reach the WAL in either order — last-state-wins converges both
    orders to the same store. Returns True when the record changed the
    store.
    """
    if kind in codec.CUT_KINDS:
        codec.from_dict(kind, obj_dict)  # raises CutFieldError
    if kind not in codec.KINDS:
        return False
    attr, _cls, key_of = codec.KINDS[kind]
    obj = codec.from_dict(kind, obj_dict)
    key = key_of(obj)
    changed = True
    with store._lock:
        target = getattr(store, attr)
        if verb == "delete":
            if kind == "Workload":
                live = target.get(key)
                if (live is not None
                        and live.resource_version > obj.resource_version):
                    # the record order raced a newer re-insert (watchers
                    # run outside the store lock): last state wins, the
                    # stale delete is dropped — mirroring the update
                    # branch's guard
                    return False
            existed = target.pop(key, None) is not None
            if kind == "Workload":
                store._admitted.pop(key, None)
                store._admitted_infos.pop(key, None)
                store._finished_counted.discard(key)
            elif kind == "ClusterQueue":
                store.cq_generation.pop(key, None)
            changed = existed
        else:
            if kind == "Workload":
                live = target.get(key)
                if (live is not None
                        and live.resource_version > obj.resource_version):
                    return False
                target[key] = obj
                store._index_workload(obj)
                if obj.is_finished:
                    store._finished_counted.add(key)
            else:
                target[key] = obj
                if kind == "ClusterQueue":
                    store.cq_generation[key] = (
                        store.cq_generation.get(key, 0) + 1)
    if changed and emit:
        store._emit(verb, kind, obj)
    return changed


def materialize_chain(chain: list[tuple[dict, bytes]]) -> Store:
    """Rebuild a Store from a resolved checkpoint chain
    (``checkpoint.newest_valid_chain`` order: full base first).

    The base loads through ``codec.store_from_dict``; each incremental
    then upserts its ``changed`` objects, removes its ``deleted`` keys
    and replaces the store-level maps it carries whole. Indexes and
    the uid floor are recomputed once at the end — the result is
    byte-identical (canonical_dump) to the store the full-dump path
    would have checkpointed at the same instant (property-tested in
    tests/test_streaming.py).
    """
    base_meta, base_state = chain[0]
    store = codec.store_from_dict(json.loads(base_state))
    for meta, state in chain[1:]:
        data = json.loads(state)
        with store._lock:
            for kind, objs in data.get("changed", {}).items():
                if kind not in codec.KINDS:
                    continue
                attr, _cls, _key_of = codec.KINDS[kind]
                target = getattr(store, attr)
                for key, od in objs.items():
                    target[key] = codec.from_dict(kind, od)
            for kind, keys in data.get("deleted", {}).items():
                if kind not in codec.KINDS:
                    continue
                attr, _cls, _key_of = codec.KINDS[kind]
                target = getattr(store, attr)
                for key in keys:
                    target.pop(key, None)
            store.namespaces = {
                ns: dict(labels) for ns, labels
                in data.get("namespaces", {}).items()}
            store.cq_generation = {
                k: int(v) for k, v
                in data.get("cq_generation", {}).items()}
    with store._lock:
        codec.rebuild_indexes(store)
    codec.advance_uid_floor(max(
        (wl.uid for wl in store.workloads.values()), default=0))
    return store


@dataclass
class RecoveryResult:
    store: Store
    checkpoint_id: int = 0
    replayed_events: int = 0
    replayed_intents: int = 0
    unapplied_intents: int = 0
    fence_violations: int = 0
    torn_tail: bool = False
    #: obs rings restored from the journal/ledger dumps written at
    #: checkpoint time (docs/OBSERVABILITY.md "Cluster health & SLOs")
    journal_events_restored: int = 0
    ledger_rows_restored: int = 0

    def to_dict(self) -> dict:
        return {"checkpoint_id": self.checkpoint_id,
                "replayed_events": self.replayed_events,
                "replayed_intents": self.replayed_intents,
                "unapplied_intents": self.unapplied_intents,
                "fence_violations": self.fence_violations,
                "torn_tail": self.torn_tail,
                "journal_events_restored": self.journal_events_restored,
                "ledger_rows_restored": self.ledger_rows_restored}


class PersistenceManager:
    def __init__(self, dir_path: str, fsync: str = FSYNC_BATCH,
                 batch_records: int = 64,
                 checkpoint_interval_records: int = 10_000,
                 checkpoint_interval_seconds: float = 300.0,
                 keep_checkpoints: int = 2,
                 audit_interval_seconds: float = 0.0,
                 audit_auto_heal: bool = False,
                 persist_obs: bool = True,
                 incremental: bool = False,
                 full_checkpoint_every: int = 16,
                 ship_to: Optional[str] = None,
                 ship_compact: bool = True,
                 clock=time.monotonic) -> None:
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self.fsync = fsync
        #: incremental checkpoints (docs/DURABILITY.md): delta against
        #: the previous checkpoint keyed by the event-driven dirty
        #: sets, making sub-second cadences affordable (a full 50k-
        #: workload serialize costs seconds; a <5% dirty delta costs a
        #: small fraction of that). Every full_checkpoint_every-th
        #: checkpoint (and the first after attach/recovery, whose
        #: dirty baseline is unknown) is a full dump, bounding chain
        #: length and recovery fan-in.
        self.incremental = incremental
        self.full_checkpoint_every = max(1, int(full_checkpoint_every))
        #: per-kind dirty/deleted keys since the last checkpoint —
        #: maintained by the same watch events the WAL logs, so the
        #: delta is exactly what the WAL suffix would replay
        self._dirty: dict[str, set] = {}
        self._deleted: dict[str, set] = {}
        #: True only while dirty tracking has been continuous since a
        #: checkpoint THIS manager wrote (the delta baseline)
        self._baseline_ok = False
        self._incr_since_full = 0
        #: WAL log shipping to a warm standby (persist/shipping.py):
        #: every flush ships the synced tail, every rotation ships the
        #: sealed (compacted) segment + checkpoint
        self.shipper = None
        if ship_to:
            from kueue_oss_tpu_torch.persist.shipping import LogShipper

            self.shipper = LogShipper(ship_to, compact=ship_compact)
        #: dump/restore the obs journal + cycle-ledger rings alongside
        #: checkpoints so explain/replay and per-cycle health records
        #: survive restarts (closes the ROADMAP durability item)
        self.persist_obs = persist_obs
        self.batch_records = batch_records
        self.checkpoint_interval_records = checkpoint_interval_records
        self.checkpoint_interval_seconds = checkpoint_interval_seconds
        self.keep_checkpoints = max(1, keep_checkpoints)
        #: background invariant-auditor cadence; attach() starts the
        #: thread when > 0 (PersistenceConfig.audit_interval_seconds)
        self.audit_interval_seconds = audit_interval_seconds
        self.audit_auto_heal = audit_auto_heal
        self.auditor = None
        self.clock = clock
        self._lock = threading.RLock()
        self.store: Optional[Store] = None
        self._replaying = False
        self._records_since_ckpt = 0
        self._last_ckpt_at = clock()
        # a crash between checkpoint temp-write and publish leaves the
        # temp file behind; it is never trusted, so sweep it on start
        for name in os.listdir(dir_path):
            if ".ckpt.tmp." in name:
                try:
                    os.unlink(os.path.join(dir_path, name))
                except OSError:
                    pass
        ckpts = ckpt.list_checkpoints(dir_path)
        self.segment = ckpts[0][0] if ckpts else 0
        self.wal = WriteAheadLog(_segment_path(dir_path, self.segment),
                                 fsync=fsync, batch_records=batch_records)
        if self.shipper is not None:
            self._bootstrap_shipping()

    def _bootstrap_shipping(self) -> None:
        """Ship the pre-existing durable state once: every published
        checkpoint and every sealed segment, so a standby attached to
        a mid-life primary can bootstrap (checkpoint chain + suffix)
        instead of needing segment zero."""
        for _ckpt_id, path in ckpt.list_checkpoints(self.dir):
            try:
                self.shipper.ship_checkpoint(path)
            except OSError:
                pass
        for name in sorted(os.listdir(self.dir)):
            m = _SEG.match(name)
            if m and int(m.group(1)) < self.segment:
                try:
                    self.shipper.ship_sealed(
                        int(m.group(1)), os.path.join(self.dir, name))
                except OSError:
                    pass

    @classmethod
    def from_config(cls, cfg) -> "PersistenceManager":
        """Build from config.PersistenceConfig (dir required)."""
        if not cfg.dir:
            raise ValueError("persistence.dir is required")
        return cls(cfg.dir, fsync=cfg.fsync,
                   batch_records=cfg.batch_records,
                   checkpoint_interval_records=(
                       cfg.checkpoint_interval_records),
                   checkpoint_interval_seconds=(
                       cfg.checkpoint_interval_seconds),
                   keep_checkpoints=cfg.keep_checkpoints,
                   audit_interval_seconds=cfg.audit_interval_seconds,
                   audit_auto_heal=cfg.audit_auto_heal,
                   incremental=cfg.incremental_checkpoints,
                   full_checkpoint_every=cfg.full_checkpoint_every,
                   ship_to=cfg.ship_to,
                   ship_compact=cfg.ship_compact)

    # -- logging -----------------------------------------------------------

    def attach(self, store: Store) -> None:
        """Subscribe to the store's watch stream and become its
        ``store.persistence`` handle (the scheduler and solver engine
        find the intent/flush surface there). With a configured audit
        cadence, the background invariant auditor starts here too."""
        self.store = store
        store.persistence = self
        store.watch(self._on_event)
        if self.audit_interval_seconds > 0 and self.auditor is None:
            from kueue_oss_tpu_torch.persist.auditor import InvariantAuditor

            self.auditor = InvariantAuditor(
                store, auto_heal=self.audit_auto_heal)
            self.auditor.start(interval_s=self.audit_interval_seconds)

    def _on_event(self, event) -> None:
        if self._replaying:
            return
        verb, kind, obj = event
        if kind not in codec.KINDS:
            return
        rec = {"t": "event", "verb": verb, "kind": kind,
               "obj": codec.to_dict(obj)}
        with self._lock:
            self.wal.append(rec, kind="event")
            self._records_since_ckpt += 1
            if self.incremental:
                _attr, _cls, key_of = codec.KINDS[kind]
                key = key_of(obj)
                if verb == "delete":
                    self._dirty.get(kind, set()).discard(key)
                    self._deleted.setdefault(kind, set()).add(key)
                else:
                    self._deleted.get(kind, set()).discard(key)
                    self._dirty.setdefault(kind, set()).add(key)

    def intent(self, op: str, wl_key: str, rv: int, *, cycle: int = 0,
               cluster_queue: str = "", detail: Optional[dict] = None
               ) -> None:
        """Durable decision record, written BEFORE the store mutation.

        ``rv`` is the workload's pre-mutation resource_version — the
        fence ``update_workload_if`` preconditions on; the mutation the
        intent announces lands at rv+1, which is how recovery tells an
        applied decision from a lost one.

        Durability follows the configured fsync policy: the intent is
        appended to the same WAL strictly before its event, so file
        order alone guarantees recovery never sees an event without
        its fence — a per-intent fsync under group commit would buy
        nothing (this control plane has no external side effects
        between intent and apply) while costing one fsync per admitted
        workload on drain-heavy cycles.
        """
        rec = {"t": "intent", "op": op, "wl": wl_key, "rv": int(rv),
               "cycle": int(cycle), "cq": cluster_queue}
        if detail:
            rec["detail"] = detail
        with self._lock:
            self.wal.append(rec, kind="intent")
            self._records_since_ckpt += 1
        hooks.crash_if("post_fsync_pre_apply")

    def flush(self) -> None:
        """Cycle-end group commit + checkpoint cadence check. With a
        shipper attached, the freshly durable tail ships before the
        cadence check — failover cost stays bounded by one flush."""
        with self._lock:
            self.wal.sync()
            if self.shipper is not None:
                try:
                    self.shipper.ship_tail(self.segment, self.wal.path,
                                           self.wal.synced_size)
                except OSError:
                    pass  # a dead standby must never stall the plane
        self.maybe_checkpoint()

    # -- checkpoints -------------------------------------------------------

    def maybe_checkpoint(self) -> bool:
        if self.store is None:
            return False
        with self._lock:
            due = (self._records_since_ckpt
                   >= self.checkpoint_interval_records)
            if (not due and self.checkpoint_interval_seconds > 0
                    and self._records_since_ckpt > 0):
                due = (self.clock() - self._last_ckpt_at
                       >= self.checkpoint_interval_seconds)
            if not due:
                return False
        self.checkpoint()
        return True

    def _incremental_state(self, base_id: int) -> bytes:
        """Delta payload against checkpoint ``base_id``: the dirty
        keys' full post-mutation objects + deleted keys, plus the
        (small) store-level maps carried whole. Byte-stable like the
        full dump — canonical JSON of a sorted structure."""
        store = self.store
        changed: dict[str, dict] = {}
        deleted: dict[str, list] = {}
        with store._lock:
            for kind, keys in self._dirty.items():
                if not keys:
                    continue
                attr, _cls, _key_of = codec.KINDS[kind]
                target = getattr(store, attr)
                out: dict[str, dict] = {}
                for key in keys:
                    obj = target.get(key)
                    if obj is None:
                        # raced a delete whose event we also saw; the
                        # deleted set already covers it
                        deleted.setdefault(kind, []).append(key)
                    else:
                        out[key] = codec.to_dict(obj)
                if out:
                    changed[kind] = out
            for kind, keys in self._deleted.items():
                if keys:
                    deleted.setdefault(kind, []).extend(keys)
            payload = {
                "version": 1,
                "base": int(base_id),
                "changed": changed,
                "deleted": {k: sorted(set(v))
                            for k, v in deleted.items()},
                "namespaces": {ns: dict(labels) for ns, labels
                               in store.namespaces.items()},
                "cq_generation": dict(store.cq_generation),
            }
        return codec.canonical_json(payload)

    def checkpoint(self, force_full: bool = False) -> int:
        """Atomic checkpoint + WAL rotation; returns the new id.

        With ``incremental`` enabled, the payload is a delta against
        the previous checkpoint (tracked dirty keys) unless the chain
        budget is spent, the baseline is unknown (first checkpoint of
        this manager's life, or right after a recovery), or
        ``force_full``.
        """
        if self.store is None:
            raise RuntimeError("no store attached")
        t0 = time.monotonic()
        with self._lock:
            self.wal.sync()
            incr = (self.incremental and self._baseline_ok
                    and not force_full
                    and self._incr_since_full + 1
                    < self.full_checkpoint_every)
            extra_meta = None
            if incr:
                state = self._incremental_state(self.segment)
                extra_meta = {"kind": "incremental",
                              "base": int(self.segment)}
            else:
                state = codec.canonical_dump(self.store)
            new_id = self.segment + 1
            try:
                # open the NEW segment before publishing the
                # checkpoint: if this fails (ENOSPC, EMFILE) nothing
                # was published and appends continue into the old
                # segment, still covered by the old checkpoint. The
                # reverse order would strand post-checkpoint records
                # in a segment recovery never replays. A stray empty
                # wal-(n+1).log from a crash between these steps is
                # harmless — replay visits it and finds nothing.
                new_wal = WriteAheadLog(
                    _segment_path(self.dir, new_id),
                    fsync=self.fsync, batch_records=self.batch_records)
                try:
                    ckpt_path = ckpt.write_checkpoint(
                        self.dir, new_id, state,
                        extra_meta=extra_meta)
                except BaseException:
                    new_wal.close()
                    raise
            except Exception:
                metrics.checkpoints_total.inc("failed")
                raise
            # rotate: records from here on belong to the new segment
            old_wal, self.wal = self.wal, new_wal
            old_wal.close()
            old_path = _segment_path(self.dir, self.segment)
            old_seg = self.segment
            ckpt.fsync_dir(self.dir)
            self.segment = new_id
            self._records_since_ckpt = 0
            self._last_ckpt_at = self.clock()
            # the dirty baseline resets: the checkpoint just written
            # covers everything tracked so far
            self._dirty = {}
            self._deleted = {}
            self._baseline_ok = True
            self._incr_since_full = (self._incr_since_full + 1
                                     if incr else 0)
            if self.shipper is not None:
                # rotation shipping: seal (compact) the outgoing
                # segment, then the checkpoint — best-effort, a dead
                # standby never unpublishes a checkpoint
                try:
                    self.shipper.ship_sealed(old_seg, old_path)
                    self.shipper.ship_checkpoint(ckpt_path)
                except OSError:
                    pass
            if not incr:
                # obs rings ride FULL checkpoints only: bounded rings
                # re-dumped at sub-second incremental cadence would
                # dominate the bytes the delta just saved
                self._dump_obs_rings(new_id)
            self._prune(new_id)
        metrics.checkpoints_total.inc(
            "incremental" if incr else "written")
        metrics.checkpoint_bytes.set(
            "incremental" if incr else "full", value=len(state))
        metrics.checkpoint_duration_seconds.observe(
            value=time.monotonic() - t0)
        return new_id

    def _dump_obs_rings(self, ckpt_id: int) -> None:
        """Persist the decision journal and the cycle ledger next to
        the checkpoint (dump_jsonl is already atomic + dir-fsynced).
        Best-effort: the checkpoint itself is the durability contract;
        a failed ring dump is logged via the failed counter but must
        never unpublish a checkpoint that already landed."""
        if not self.persist_obs:
            return
        from kueue_oss_tpu_torch import obs

        # each ring dumps in its own try: a journal ENOSPC must not
        # also cost the ledger its dump for this checkpoint
        for kind, ring in (("journal", obs.recorder),
                           ("ledger", obs.cycle_ledger)):
            try:
                ring.dump_jsonl(_obs_path(self.dir, kind, ckpt_id))
            except OSError:
                metrics.checkpoints_total.inc(f"obs_{kind}_dump_failed")

    def _prune(self, newest_id: int) -> None:
        """WAL truncation on checkpoint success: drop checkpoints
        beyond the retention window and every WAL segment older than
        the oldest retained checkpoint. Retention closes over delta
        chains: a retained incremental keeps its full base (and every
        intermediate link) alive regardless of the window — pruning a
        base would orphan every incremental above it."""
        listed = ckpt.list_checkpoints(self.dir)
        retained: set[int] = set()
        for ckpt_id, _path in listed[:self.keep_checkpoints]:
            retained |= ckpt.chain_ids(self.dir, ckpt_id)
        oldest_kept = min(retained, default=newest_id)
        for ckpt_id, path in listed:
            if ckpt_id in retained:
                continue
            try:
                os.unlink(path)
            except OSError:
                pass
        for name in os.listdir(self.dir):
            m = _SEG.match(name)
            if m and int(m.group(1)) < oldest_kept:
                try:
                    os.unlink(os.path.join(self.dir, name))
                except OSError:
                    pass
            mo = _OBS.match(name)
            if mo and int(mo.group(2)) < oldest_kept:
                # obs ring dumps retire with their checkpoint
                try:
                    os.unlink(os.path.join(self.dir, name))
                except OSError:
                    pass

    # -- recovery ----------------------------------------------------------

    def recover(self, store: Optional[Store] = None,
                emit: bool = False) -> RecoveryResult:
        """Rebuild state: newest valid checkpoint + WAL suffix replay.

        ``store=None`` builds a fresh Store. Passing an existing store
        (a promoted replica warming up) SYNCS it to durable state —
        upserts for everything durable, deletes for anything the store
        holds that durable state does not (a re-promoted ex-leader may
        carry objects deleted during its time as follower); with
        ``emit=True`` every applied change re-emits through the watch
        stream so watch-driven caches warm in the same pass.
        """
        chain = ckpt.newest_valid_chain(self.dir)
        loaded = chain is not None
        # durable state is always materialized into a fresh raw store
        # first — a pure function of checkpoint + log, independent of
        # whatever the target store currently holds
        result = RecoveryResult(store=Store())
        # any pre-recovery dirty baseline is void: the next checkpoint
        # after a recovery is always a full dump
        self._baseline_ok = False
        self._dirty = {}
        self._deleted = {}
        self._replaying = True
        try:
            if loaded:
                result.checkpoint_id = int(chain[-1][0]["id"])
                result.store = materialize_chain(chain)
            self._replay_segments(result, emit=False,
                                  start=result.checkpoint_id)
            # the active segment's torn tail may have been truncated
            # away when this manager opened it — still a torn tail
            result.torn_tail = (result.torn_tail
                                or self.wal.truncated_bytes > 0)
            # the uid floor must cover WAL-replayed workloads too (and
            # WAL-only recoveries, which never touch the checkpoint
            # branch): a re-issued uid would alias queue-order
            # tie-breaks and session slots
            codec.advance_uid_floor(max(
                (wl.uid for wl in result.store.workloads.values()),
                default=0))
            if store is not None:
                self._sync_into(store, result.store, emit=emit)
                result.store = store
        finally:
            self._replaying = False
        self._restore_obs_rings(result)
        metrics.recovery_total.inc(
            "checkpoint" if loaded else
            ("wal_only" if result.replayed_events else "empty"))
        metrics.recovery_replayed_records.set(
            value=result.replayed_events + result.replayed_intents)
        return result

    def _restore_obs_rings(self, result: RecoveryResult) -> None:
        """Restore the decision journal and cycle ledger from the
        newest ring dumps in the durability dir, so ``explain`` /
        journal replay and per-cycle health records survive a restart.
        Loaders are torn-line tolerant; a missing dump (pre-upgrade
        dir, or rings disabled at dump time) restores nothing."""
        if not self.persist_obs:
            return
        from kueue_oss_tpu_torch import obs

        # each ring restores from ITS OWN newest dump: a failed ledger
        # dump at checkpoint N must not hide the intact ledger-(N-1)
        # behind a journal-N that did land
        newest: dict[str, int] = {}
        for n in os.listdir(self.dir):
            m = _OBS.match(n)
            if m and int(m.group(2)) > newest.get(m.group(1), -1):
                newest[m.group(1)] = int(m.group(2))
        if "journal" in newest:
            result.journal_events_restored = obs.recorder.restore(
                obs.load_jsonl(_obs_path(self.dir, "journal",
                                         newest["journal"])))
            # the SLO windows die with the process; rebuild them from
            # the restored journal's recorded waits so burn state (and
            # a firing alert) survives the restart (docs/DURABILITY.md)
            obs.slo_engine.replay_journal(obs.recorder.events())
        if "ledger" in newest:
            result.ledger_rows_restored = obs.cycle_ledger.restore(
                obs.load_ledger_jsonl(_obs_path(self.dir, "ledger",
                                                newest["ledger"])))

    @staticmethod
    def _sync_into(target: Store, durable: Store, emit: bool) -> None:
        """Make `target` mirror `durable`: delete extras, upsert the
        rest, all raw (no version bumps), then re-emit each change so
        the target's watchers track the sync. Emission follows the
        store convention (outside the lock, after the mutation)."""
        events: list[tuple[str, str, object]] = []
        with target._lock:
            for kind, (attr, _cls, _key_of) in codec.KINDS.items():
                src = getattr(durable, attr)
                dst = getattr(target, attr)
                for key in [k for k in dst if k not in src]:
                    gone = dst.pop(key)
                    if kind == "ClusterQueue":
                        target.cq_generation.pop(key, None)
                    events.append(("delete", kind, gone))
                for key, obj in src.items():
                    dst[key] = obj
                    events.append(("update", kind, obj))
            target.namespaces = {ns: dict(labels) for ns, labels
                                 in durable.namespaces.items()}
            target.cq_generation = dict(durable.cq_generation)
            codec.rebuild_indexes(target)
        if emit:
            for verb, kind, obj in events:
                target._emit(verb, kind, obj)

    def _replay_segments(self, result: RecoveryResult, emit: bool,
                         start: int) -> None:
        seg_ids = sorted(
            int(m.group(1)) for m in
            (_SEG.match(n) for n in os.listdir(self.dir)) if m)
        #: intent fences awaiting their apply event: wl key -> [rv]
        pending: dict[str, list[int]] = {}
        for seg in seg_ids:
            if seg < start:
                continue
            records, torn = replay_wal(_segment_path(self.dir, seg))
            result.torn_tail = result.torn_tail or torn
            for rec in records:
                if rec.get("t") == "intent":
                    result.replayed_intents += 1
                    pending.setdefault(rec["wl"], []).append(
                        int(rec["rv"]))
                    continue
                if rec.get("t") != "event":
                    continue
                result.replayed_events += 1
                kind, verb = rec["kind"], rec["verb"]
                if kind == "Workload":
                    key = rec["obj"].get("namespace", "") + "/" + \
                        rec["obj"].get("name", "")
                    fences = pending.get(key)
                    if fences:
                        rv = int(rec["obj"].get("resource_version", 0))
                        if verb == "delete" or rv == fences[0] + 1:
                            fences.pop(0)
                        elif rv > fences[0] + 1:
                            # the fence's mutation was skipped but a
                            # LATER write landed: the optimistic
                            # precondition was violated
                            result.fence_violations += 1
                            fences.pop(0)
                        if not fences:
                            pending.pop(key, None)
                apply_event(result.store, verb, kind, rec["obj"],
                            emit=emit)
        result.unapplied_intents = sum(len(v) for v in pending.values())

    def close(self) -> None:
        if self.auditor is not None:
            self.auditor.stop()
        # detach from the store: a scheduler that keeps cycling after
        # close() must fall back to the no-persistence path, not write
        # intents into a closed WAL
        store = getattr(self, "store", None)
        if store is not None:
            if getattr(store, "persistence", None) is self:
                store.persistence = None
            if self._on_event in store._watchers:
                store._watchers.remove(self._on_event)
        with self._lock:
            self.wal.close()
            if self.shipper is not None:
                # a clean shutdown leaves the standby fully caught up
                try:
                    self.shipper.ship_tail(self.segment, self.wal.path,
                                           self.wal.synced_size)
                except OSError:
                    pass

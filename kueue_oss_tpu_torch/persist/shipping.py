"""WAL log shipping to a warm standby (docs/DURABILITY.md).

A copy of ``kueue_oss_tpu/persist/shipping.py``.

The durable control plane's failover cost used to be a full recovery:
newest checkpoint + replay of the whole active segment. Log shipping
shrinks it to the **unsynced tail**: the primary continuously copies
its durable WAL prefix (and every published checkpoint) into a standby
directory, and a follower replays shipped records into a live store as
they arrive — promotion only applies whatever landed since the last
catch-up tick.

Three shipping streams, all modeled as directory-to-directory byte
copies (a production deployment points the target at replicated
storage or wraps ``LogShipper`` over a network transport; the
correctness story — what is shipped when, and what the follower does
with it — is identical):

- **tail**: after every group commit, the active segment's synced
  suffix ``[shipped, synced_size)`` is appended to the standby's copy.
  Only durable bytes ship, so the standby can never be *ahead* of what
  the primary would itself recover.
- **sealed**: on rotation, the outgoing segment finishes shipping and
  is marked complete. A sealed segment that never tail-shipped (the
  shipper attached mid-life, or a bootstrap over an existing dir) is
  **compacted** first: per-key last-state-wins drops superseded event
  records and satisfied intents (``compact_records``) — the follower's
  replay applies last-state-wins anyway, so the recovered store is
  byte-identical while the shipped bytes shrink with churn. Segments
  with a partial standby copy ship their remaining tail verbatim
  (appending to a compacted prefix would corrupt frame offsets).
- **checkpoint**: every published checkpoint (full or incremental)
  copies over, so a cold standby can bootstrap without segment zero.

``WarmStandby`` is the follower: a live Store fed by ``catch_up()``
(resumable per-segment frame cursors via ``wal.scan_records``), with
``promote()`` = one final catch-up. The SIGKILL failover test proves
the promoted store is byte-identical to what the dead primary's own
recovery would produce, and that promotion replayed only the tail.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from kueue_oss_tpu_torch import metrics
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.persist import checkpoint as ckpt
from kueue_oss_tpu_torch.persist import codec
from kueue_oss_tpu_torch.persist import wal as wal_mod
from kueue_oss_tpu_torch.util.fsutil import fsync_dir

_SEG = re.compile(r"^wal-(\d+)\.log$")
_CKPT = re.compile(r"^checkpoint-(\d+)\.ckpt$")


def compact_records(records: list[dict]) -> tuple[list[dict], int]:
    """Per-key log compaction: keep only the LAST event per
    (kind, key) — replay is last-state-wins, so the surviving suffix
    recovers the identical store — and drop intents whose fence was
    satisfied inside the segment (a following event at rv+1, or a
    delete). Unmatched trailing intents survive so the follower's
    recovery diagnostics (unapplied_intents) still see them.
    Survivors keep their relative order. Returns (kept, dropped)."""
    last_event: dict[tuple[str, str], int] = {}
    for i, rec in enumerate(records):
        if rec.get("t") == "event":
            key = _event_key(rec)
            if key is not None:
                last_event[key] = i
    satisfied: set[int] = set()
    pending: dict[str, list[tuple[int, int]]] = {}
    for i, rec in enumerate(records):
        if rec.get("t") == "intent":
            pending.setdefault(rec.get("wl", ""), []).append(
                (i, int(rec.get("rv", -1))))
        elif rec.get("t") == "event" and rec.get("kind") == "Workload":
            obj = rec.get("obj") or {}
            wl_key = (obj.get("namespace", "") + "/"
                      + obj.get("name", ""))
            fences = pending.get(wl_key)
            if fences:
                idx, rv = fences[0]
                orv = int(obj.get("resource_version", 0))
                if rec.get("verb") == "delete" or orv >= rv + 1:
                    satisfied.add(idx)
                    fences.pop(0)
    kept: list[dict] = []
    for i, rec in enumerate(records):
        t = rec.get("t")
        if t == "event":
            key = _event_key(rec)
            if key is not None and last_event.get(key) != i:
                continue
        elif t == "intent" and i in satisfied:
            continue
        kept.append(rec)
    return kept, len(records) - len(kept)


def _event_key(rec: dict) -> Optional[tuple[str, str]]:
    kind = rec.get("kind", "")
    if kind not in codec.KINDS:
        return None
    obj = rec.get("obj") or {}
    if kind in ("Workload", "LocalQueue"):
        key = obj.get("namespace", "") + "/" + obj.get("name", "")
    else:
        key = obj.get("name", "")
    return kind, key


class LogShipper:
    """Primary-side shipping into a standby directory."""

    def __init__(self, target_dir: str, compact: bool = True) -> None:
        self.target = target_dir
        self.compact = compact
        os.makedirs(target_dir, exist_ok=True)
        #: seg id -> bytes shipped so far (tail cursor). A restarted
        #: shipper resumes from the TARGET file's size — tail copies
        #: are verbatim prefixes, so the existing bytes are the cursor
        self._shipped: dict[int, int] = {}
        #: segments fully shipped + sealed (in-memory fast path; the
        #: durable record is the target-side .sealed marker, so a
        #: restarted shipper never re-ships — or worse, appends
        #: verbatim source bytes after a shorter compacted copy)
        self._sealed: set[int] = set()
        self.shipped_bytes = 0
        self.compaction_dropped = 0

    def _target_seg(self, seg_id: int) -> str:
        return os.path.join(self.target, f"wal-{seg_id:08d}.log")

    def _seal_marker(self, seg_id: int) -> str:
        return self._target_seg(seg_id) + ".sealed"

    def _is_sealed(self, seg_id: int) -> bool:
        if seg_id in self._sealed:
            return True
        if os.path.exists(self._seal_marker(seg_id)):
            self._sealed.add(seg_id)
            return True
        return False

    def _done(self, seg_id: int) -> int:
        """Bytes already on the target (verbatim-prefix invariant)."""
        done = self._shipped.get(seg_id)
        if done is None:
            try:
                done = os.path.getsize(self._target_seg(seg_id))
            except OSError:
                done = 0
            self._shipped[seg_id] = done
        return done

    def ship_tail(self, seg_id: int, path: str, synced_len: int) -> int:
        """Append the segment's durable suffix to the standby copy;
        returns bytes shipped this call."""
        if self._is_sealed(seg_id):
            return 0
        done = self._done(seg_id)
        if synced_len <= done:
            return 0
        with open(path, "rb") as src:
            src.seek(done)
            payload = src.read(synced_len - done)
        tgt = self._target_seg(seg_id)
        with open(tgt, "ab") as dst:
            dst.write(payload)
            dst.flush()
            os.fsync(dst.fileno())
        self._shipped[seg_id] = done + len(payload)
        self.shipped_bytes += len(payload)
        metrics.wal_shipped_bytes_total.inc("tail", by=len(payload))
        return len(payload)

    def ship_sealed(self, seg_id: int, path: str) -> None:
        """Finish a rotated segment. Copies with ANY existing target
        bytes (tail-shipped this life or a previous one — verbatim
        prefixes by invariant) get their remaining durable bytes
        appended verbatim; only untouched segments ship compacted
        (per-key last-state-wins). A .sealed marker on the target
        makes completion durable across shipper restarts — appending
        verbatim source bytes after a shorter compacted copy would
        corrupt the follower's frame stream."""
        if self._is_sealed(seg_id):
            return
        try:
            size = wal_mod.valid_prefix_len(path)
        except OSError:
            return
        done = self._done(seg_id)
        if done > 0 and not self._target_is_prefix(seg_id, path, done):
            # the target is a COMPLETE compacted copy whose .sealed
            # marker was lost to a crash between the atomic publish
            # and the marker write: compaction lands via os.replace,
            # so a non-prefix target can only be the whole compacted
            # stream — appending verbatim source bytes after it would
            # corrupt the follower's frames. Just restore the marker.
            self._sealed.add(seg_id)
            with open(self._seal_marker(seg_id), "wb"):
                pass
            fsync_dir(self.target)
            return
        if done > 0 or not self.compact:
            self.ship_tail(seg_id, path, size)
        else:
            records, _torn = wal_mod.replay_wal(path)
            kept, dropped = compact_records(records)
            payload = b"".join(wal_mod.encode_frame(r) for r in kept)
            tgt = self._target_seg(seg_id)
            tmp = f"{tgt}.tmp.{os.getpid()}"
            try:
                with open(tmp, "wb") as dst:
                    dst.write(payload)
                    dst.flush()
                    os.fsync(dst.fileno())
                os.replace(tmp, tgt)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self._shipped[seg_id] = size
            self.shipped_bytes += len(payload)
            self.compaction_dropped += dropped
            metrics.wal_shipped_bytes_total.inc(
                "sealed", by=len(payload))
            metrics.wal_compaction_dropped_total.inc(by=dropped)
        self._sealed.add(seg_id)
        with open(self._seal_marker(seg_id), "wb"):
            pass
        fsync_dir(self.target)

    def _target_is_prefix(self, seg_id: int, path: str,
                          done: int) -> bool:
        """Whether the target's bytes are a verbatim prefix of the
        source (the tail-shipping invariant). Runs only on the
        rotation-rare sealed path."""
        try:
            with open(self._target_seg(seg_id), "rb") as t, \
                    open(path, "rb") as s:
                while done > 0:
                    chunk = t.read(min(done, 1 << 20))
                    if not chunk or s.read(len(chunk)) != chunk:
                        return False
                    done -= len(chunk)
            return True
        except OSError:
            return False

    def ship_checkpoint(self, path: str) -> None:
        """Copy one published checkpoint file (atomic on the target:
        temp + replace, the checkpoint writer's own discipline)."""
        name = os.path.basename(path)
        tgt = os.path.join(self.target, name)
        tmp = f"{tgt}.tmp.{os.getpid()}"
        try:
            with open(path, "rb") as src, open(tmp, "wb") as dst:
                data = src.read()
                dst.write(data)
                dst.flush()
                os.fsync(dst.fileno())
            os.replace(tmp, tgt)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        fsync_dir(self.target)
        self.shipped_bytes += len(data)
        metrics.wal_shipped_bytes_total.inc("checkpoint", by=len(data))


class WarmStandby:
    """Follower: continuous replay of a shipped directory into a live
    store, so failover applies only the not-yet-replayed tail.

    ``catch_up()`` is idempotent and cheap when nothing new arrived
    (one listdir + per-segment cursor checks); call it on any cadence.
    ``promote()`` is the failover: one final catch-up, then the store
    is the recovered state — byte-identical to what the dead
    primary's own ``PersistenceManager.recover()`` would produce from
    its durable prefix.
    """

    def __init__(self, dir_path: str) -> None:
        self.dir = dir_path
        self.store = Store()
        self._bootstrapped = False
        self._start_segment = 0
        #: seg id -> applied byte offset (frame-boundary cursor)
        self._cursor: dict[int, int] = {}
        self.records_applied = 0
        self.last_catch_up_records = 0
        #: standby-side GC of superseded shipped files (segments the
        #: bootstrap anchor retired, checkpoints outside the newest
        #: chain); on by default — the standby directory otherwise
        #: grows without bound while the primary's own retention only
        #: prunes the SOURCE directory
        self.prune = True
        self.rebootstraps = 0
        self.pruned_files = 0

    def _bootstrap(self) -> None:
        """Load the newest shipped checkpoint chain (if any) once;
        segments older than it never replay. A standby attached to a
        mid-life primary must wait for its first shipped checkpoint —
        replaying a history that starts past segment zero would build
        a partial store, so bootstrap retries until either a
        checkpoint or segment zero is visible."""
        if self._bootstrapped:
            return
        chain = ckpt.newest_valid_chain(self.dir)
        if chain is not None:
            from kueue_oss_tpu_torch.persist.manager import (
                materialize_chain,
            )

            self.store = materialize_chain(chain)
            self._start_segment = int(chain[-1][0]["id"])
        elif not os.path.exists(
                os.path.join(self.dir, "wal-00000000.log")):
            return  # mid-life attach: wait for the first checkpoint
        self._bootstrapped = True

    def _replay_position(self) -> int:
        """The segment catch-up would touch next: every present
        segment before it is fully consumed. An absent or unreadable
        segment IS the position — replay cannot get past it (in-order
        stop), which is exactly what a superseding checkpoint heals."""
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return self._start_segment
        segs = sorted(int(m.group(1)) for m in
                      (_SEG.match(n) for n in names) if m)
        pos = self._start_segment
        for seg in segs:
            if seg < pos:
                continue
            if seg > pos:
                break  # shipped history has a hole: stuck before it
            try:
                size = os.path.getsize(
                    os.path.join(self.dir, f"wal-{seg:08d}.log"))
            except OSError:
                break
            if self._cursor.get(seg, 0) < size:
                break  # unconsumed bytes: replay works here next
            pos = seg + 1
        return pos

    def _maybe_rebootstrap(self) -> None:
        """Auto-re-bootstrap: a newer shipped checkpoint whose anchor
        segment is MORE THAN ONE segment ahead of the replay frontier
        supersedes it — the chain already embodies every record the
        standby would have replayed to get there, including segments
        that never shipped or sit behind an unreadable one (catch_up's
        in-order stop). Re-materializing from the chain is one bounded
        rebuild instead of a long — or permanently wedged — segment
        replay. Steady-state tailing never re-bootstraps: each
        rotation's checkpoint anchors exactly one segment past the
        frontier, and that boundary keeps the cheap replay path."""
        chain = ckpt.newest_valid_chain(self.dir)
        if chain is None:
            return
        new_start = int(chain[-1][0]["id"])
        if new_start <= self._replay_position() + 1:
            return
        from kueue_oss_tpu_torch.persist.manager import materialize_chain

        self.store = materialize_chain(chain)
        self._start_segment = new_start
        self._cursor = {s: off for s, off in self._cursor.items()
                        if s >= new_start}
        self.rebootstraps += 1
        metrics.wal_standby_rebootstraps_total.inc()

    def _prune_superseded(self) -> None:
        """Standby-side GC: shipped segments older than the bootstrap
        anchor never replay again, and checkpoint files outside the
        newest valid chain can never be materialized (the chain's base
        is a full dump). Deleting them bounds the standby directory to
        the live chain + replayable segments; nothing catch_up() could
        still read is ever removed. ``.sealed`` markers of pruned
        segments are KEPT — they are zero-byte, and a restarted
        shipper sharing the directory uses them to know a sealed
        segment completed (deleting one would trigger a pointless
        re-ship of a segment this standby already retired)."""
        if not self.prune or not self._bootstrapped:
            return
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return
        chain = ckpt.newest_valid_chain(self.dir)
        keep_ckpts = (None if chain is None
                      else {int(m["id"]) for m, _ in chain})
        removed = 0
        for n in names:
            m = _SEG.match(n)
            if m is not None:
                if int(m.group(1)) < self._start_segment:
                    removed += self._rm(n)
                continue
            c = _CKPT.match(n)
            if (c is not None and keep_ckpts is not None
                    and int(c.group(1)) not in keep_ckpts):
                removed += self._rm(n)
        if removed:
            self.pruned_files += removed
            metrics.wal_standby_pruned_total.inc(by=removed)
            fsync_dir(self.dir)

    def _rm(self, name: str) -> int:
        try:
            os.unlink(os.path.join(self.dir, name))
            return 1
        except OSError:
            return 0

    def catch_up(self) -> int:
        """Apply every newly shipped complete frame; returns records
        applied this call. Before bootstrap succeeds (mid-life attach
        still waiting for its first shipped checkpoint) nothing
        replays — advancing segment cursors against an empty store
        would permanently skip those frames once the checkpoint
        arrives. Each call also re-bootstraps from a superseding
        shipped checkpoint (``_maybe_rebootstrap``) and prunes files
        the bootstrap anchor retired (``_prune_superseded``)."""
        self._bootstrap()
        if not self._bootstrapped:
            return 0
        self._maybe_rebootstrap()
        applied = 0
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return 0
        seg_ids = sorted(int(m.group(1)) for m in
                         (_SEG.match(n) for n in names) if m)
        from kueue_oss_tpu_torch.persist.manager import apply_event

        for seg in seg_ids:
            if seg < self._start_segment:
                continue
            path = os.path.join(self.dir, f"wal-{seg:08d}.log")
            start = self._cursor.get(seg, 0)
            try:
                frames = wal_mod.scan_records(path, start)
                for off, length, rec in frames:
                    if rec.get("t") == "event":
                        apply_event(self.store, rec["verb"],
                                    rec["kind"], rec["obj"])
                    self._cursor[seg] = off + length
                    applied += 1
            except OSError:
                # STOP at the first unreadable segment: replaying a
                # later segment now and this one on a retry would
                # apply older records after newer ones (last-state-
                # wins converges per key, but cross-key order — and
                # hence the promoted dump — would diverge)
                break
        self.records_applied += applied
        self.last_catch_up_records = applied
        self._prune_superseded()
        return applied

    def promote(self) -> tuple[Store, int]:
        """Failover: final catch-up (the unsynced tail), then the
        store is live. Returns (store, tail records replayed)."""
        tail = self.catch_up()
        codec.advance_uid_floor(max(
            (wl.uid for wl in self.store.workloads.values()),
            default=0))
        codec.rebuild_indexes(self.store)
        return self.store, tail

"""CRC-framed write-ahead log (docs/DURABILITY.md).

A copy of ``kueue_oss_tpu/persist/wal.py``: the same frames (a segment
written by either package replays in the other), fsync modes and
persistence rung of the degradation ladder.

Frame layout, all integers big-endian:

    magic  2B  b"KW"
    ver    1B  0x01
    len    4B  payload byte length
    crc    4B  zlib.crc32 of the payload
    payload    canonical JSON record

Records are appended by the PersistenceManager: ``event`` records carry
the full post-mutation object from ``Store._emit`` (state replay);
``intent`` records fence scheduler decisions (admit/evict/preempt)
BEFORE the store mutation they announce, carrying the workload's
pre-mutation resource_version — the same optimistic-concurrency token
``Store.update_workload_if`` preconditions on, so recovery can tell an
applied decision (a following event at rv+1) from one the crash ate.

Durability policy (`fsync`):

  always -- fsync after every append (the crash harness's setting:
            every acknowledged record survives SIGKILL)
  batch  -- group commit: fsync every `batch_records` appends and on
            explicit sync() — the scheduler flushes at cycle end, so at
            most one cycle's tail is exposed to a crash (default; the
            <5% wal_overhead_pct budget lives here)
  off    -- never fsync (bench twins, throwaway dirs)

These three modes are also the PERSISTENCE degradation ladder
(docs/ROBUSTNESS.md): an ``os.fsync`` failure (sick disk, full
filesystem, injected chaos via ``fsync_fault``) drops the effective
policy one rung and raises ``fsync_degraded`` — a second failure drops
to off and raises the ``wal_off`` alarm. The configured policy is
remembered; once the restore cooldown elapses a single probe fsync
(the controller's unified half-open discipline) restores it.

Intents follow the same policy: they are appended to the same file
strictly before the event they fence, so ORDER (not an extra fsync)
is what guarantees recovery never sees an event without its intent.

Replay tolerates a torn tail: a short header, short payload, bad magic
or CRC mismatch ends the scan at the last complete record (exactly the
state an interrupted append leaves behind).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Iterator, Optional

from kueue_oss_tpu_torch import metrics, resilience
from kueue_oss_tpu_torch.persist import hooks

MAGIC = b"KW"
VERSION = 1
_HEADER = struct.Struct(">2sBII")

FSYNC_ALWAYS = "always"
FSYNC_BATCH = "batch"
FSYNC_OFF = "off"
FSYNC_MODES = (FSYNC_ALWAYS, FSYNC_BATCH, FSYNC_OFF)


def encode_frame(record: dict) -> bytes:
    # ONE canonical encoding across every durability surface: WAL
    # payloads and checkpoint dumps must stay byte-aligned for the
    # same object (persist/codec.py owns the settings)
    from kueue_oss_tpu_torch.persist.codec import canonical_json

    payload = canonical_json(record)
    return _HEADER.pack(MAGIC, VERSION, len(payload),
                        zlib.crc32(payload)) + payload


class WriteAheadLog:
    """One append-only segment file."""

    def __init__(self, path: str, fsync: str = FSYNC_BATCH,
                 batch_records: int = 64) -> None:
        if fsync not in FSYNC_MODES:
            raise ValueError(f"fsync {fsync!r} not in {FSYNC_MODES}")
        self.path = path
        self.fsync = fsync
        #: the operator-configured policy `maybe_restore` returns to
        #: after the degradation ladder dropped `self.fsync` below it
        self._configured_fsync = fsync
        #: chaos seam: the next N fsync attempts fail as if the disk
        #: were sick (drives the persistence ladder deterministically)
        self.fsync_fault = 0
        #: quiet period before a degraded policy gets one probe fsync
        self.restore_cooldown_s = resilience.wal_restore_cooldown_s
        self.batch_records = max(1, int(batch_records))
        # A crash can leave a torn frame at the tail; appending after
        # it would strand every later record behind an unreadable
        # frame, so re-opening a segment first truncates it back to
        # its last complete frame.
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        self.truncated_bytes = 0
        if size:
            valid = valid_prefix_len(path)
            if valid < size:
                self.truncated_bytes = size - valid
                with open(path, "r+b") as f:
                    f.truncate(valid)
                    f.flush()
                    os.fsync(f.fileno())
        # buffering=0: a record handed to the OS survives a SIGKILL of
        # THIS process even before fsync; only power loss can eat it.
        self._f = open(path, "ab", buffering=0)
        self._unsynced = 0
        self.records_appended = 0
        self.bytes_appended = 0
        #: absolute file size / synced watermark — the log shipper's
        #: read bounds (tail shipping copies [shipped, synced_size))
        self.size = size - self.truncated_bytes
        self.synced_size = self.size

    def append(self, record: dict, kind: str = "event",
               sync: Optional[bool] = None) -> int:
        """Append one record; returns bytes written. `sync=True` forces
        the record durable before returning (intents)."""
        frame = encode_frame(record)
        if hooks.should_fire("pre_fsync"):
            # the record never reaches disk: durable state = everything
            # before it (deterministic stand-in for a lost page cache).
            # Close before killing: under mode="raise" a survivor must
            # not keep appending a CRC-valid log with a silently
            # dropped record in the middle (same discipline as
            # torn_tail below).
            self._fsync()
            self._f.close()
            hooks.kill()
        if hooks.should_fire("torn_tail"):
            # half a frame lands durably, then the power cut. Close the
            # handle first: under mode="raise" (in-process tests) a
            # survivor must not keep appending past a durable torn
            # frame — replay would stop there and silently lose every
            # later record; a closed file fails the next append loudly.
            self._f.write(frame[:max(1, len(frame) // 2)])
            if self.fsync != FSYNC_OFF:
                os.fsync(self._f.fileno())
            self._f.close()
            hooks.kill()
        self._f.write(frame)
        self._unsynced += 1
        self.records_appended += 1
        self.bytes_appended += len(frame)
        self.size += len(frame)
        metrics.wal_records_total.inc(kind)
        metrics.wal_bytes_total.inc(by=len(frame))
        force = sync if sync is not None else (self.fsync == FSYNC_ALWAYS)
        if force or (self.fsync == FSYNC_BATCH
                     and self._unsynced >= self.batch_records):
            self._fsync()
        return len(frame)

    def sync(self) -> None:
        """Group-commit barrier: make every appended record durable.
        Doubles as the degraded-policy restore point — the scheduler
        calls this at every cycle end, so a healed disk is re-probed
        on the admission cadence without a dedicated timer."""
        if self._unsynced:
            self._fsync()
        if self.fsync != self._configured_fsync:
            self.maybe_restore()

    def _fsync(self) -> None:
        if self.fsync == FSYNC_OFF:
            self._unsynced = 0
            # the shipping watermark still advances: fsync=off means
            # "trust the page cache", not "never replicate"
            self.synced_size = self.size
            return
        if self.fsync_fault > 0:
            self.fsync_fault -= 1
            self._degrade(OSError("injected fsync fault (chaos)"))
            return
        try:
            os.fsync(self._f.fileno())
        except OSError as e:
            self._degrade(e)
            return
        self._unsynced = 0
        self.synced_size = self.size
        metrics.wal_fsyncs_total.inc()

    def _degrade(self, err: BaseException) -> None:
        """An fsync failed: drop one durability rung rather than crash
        the admission loop — degraded-but-sound beats wedged. The
        ladder is fsync-always -> batch -> wal-off(+alarm); every hop
        is metered, journaled, and owned by the degradation
        controller, and ``maybe_restore`` walks back up after a quiet
        cooldown."""
        metrics.wal_fsync_faults_total.inc()
        ctl = resilience.controller
        if self.fsync == FSYNC_ALWAYS:
            self.fsync = FSYNC_BATCH
            ctl.report(
                resilience.PERSISTENCE, "fsync_degraded", True,
                reason=f"fsync failed ({err!r}); durability drops to "
                       "group commit")
        else:
            self.fsync = FSYNC_OFF
            ctl.report(
                resilience.PERSISTENCE, "fsync_degraded", True,
                reason=f"fsync failed ({err!r})")
            ctl.report(
                resilience.PERSISTENCE, "wal_off", True,
                reason=f"group commit failed too ({err!r}); WAL "
                       "durability OFF — page cache only (alarm)")
        # the failed barrier's records stay page-cache-only, exactly
        # like fsync=off: the watermark advances so shipping and the
        # group-commit counter don't wedge on an unreachable barrier
        self._unsynced = 0
        self.synced_size = self.size

    def maybe_restore(self) -> bool:
        """One timed half-open probe of a degraded durability policy:
        once ``restore_cooldown_s`` has passed since the last fault,
        a single caller attempts a real fsync; success restores the
        configured policy and clears the ladder conditions, failure
        restarts the cooldown."""
        if self.fsync == self._configured_fsync:
            return False
        ctl = resilience.controller
        cond = ("wal_off" if self.fsync == FSYNC_OFF
                else "fsync_degraded")
        if not ctl.begin_probe(resilience.PERSISTENCE, cond,
                               self.restore_cooldown_s):
            return False
        try:
            if self.fsync_fault > 0:
                self.fsync_fault -= 1
                raise OSError("injected fsync fault (chaos)")
            os.fsync(self._f.fileno())
        except OSError:
            metrics.wal_fsync_faults_total.inc()
            ctl.end_probe(resilience.PERSISTENCE, cond, success=False)
            return False
        self.fsync = self._configured_fsync
        self._unsynced = 0
        self.synced_size = self.size
        metrics.wal_fsyncs_total.inc()
        for c in ("wal_off", "fsync_degraded"):
            if ctl.active(resilience.PERSISTENCE, c):
                ctl.report(
                    resilience.PERSISTENCE, c, False,
                    reason="probe fsync succeeded; configured "
                           f"policy {self._configured_fsync!r} restored")
        return True

    def close(self) -> None:
        if self._f.closed:
            return
        self.sync()
        self._f.close()


def _scan(path: str, start: int = 0) -> Iterator[tuple[int, int, dict]]:
    """The ONE frame scanner: yield (offset, frame length, record) for
    each fully valid frame, stopping at the first invalid one. Every
    consumer (replay, truncation boundaries, reopen-truncation, the
    warm standby's incremental catch-up) shares these validity rules —
    a frame one path accepts and another rejects would let appends
    continue past a frame recovery stops at, permanently hiding later
    records. ``start`` must be a frame boundary (the standby resumes
    from its applied offset)."""
    with open(path, "rb") as f:
        f.seek(start)
        off = start
        while True:
            header = f.read(_HEADER.size)
            if len(header) < _HEADER.size:
                return
            try:
                magic, ver, length, crc = _HEADER.unpack(header)
            except struct.error:
                return
            if magic != MAGIC or ver != VERSION:
                return
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return
            try:
                rec = json.loads(payload)
            except ValueError:
                return
            yield off, _HEADER.size + length, rec
            off += _HEADER.size + length


def replay_wal(path: str) -> tuple[list[dict], bool]:
    """Read every complete record; returns (records, torn_tail).

    torn_tail is True when the file ends in an incomplete or corrupt
    frame — expected after a crash mid-append, and the reason WAL
    replay stops at the last complete record instead of raising.
    """
    records: list[dict] = []
    end = 0
    try:
        size = os.path.getsize(path)
    except OSError:
        return records, False
    for off, length, rec in _scan(path):
        records.append(rec)
        end = off + length
    return records, end < size


def valid_prefix_len(path: str) -> int:
    """Byte length of the longest complete-frame prefix."""
    return sum(n for _off, n in iter_frames(path))


def iter_frames(path: str) -> Iterator[tuple[int, int]]:
    """(offset, frame length) of each complete frame — the truncation
    property test cuts the file at every one of these boundaries."""
    for off, length, _rec in _scan(path):
        yield off, length


def scan_records(path: str, start: int = 0
                 ) -> Iterator[tuple[int, int, dict]]:
    """Public offset-resumable scan: (offset, frame length, record)
    from ``start`` (a frame boundary) — the warm standby's
    incremental replay cursor (persist/shipping.py)."""
    return _scan(path, start)

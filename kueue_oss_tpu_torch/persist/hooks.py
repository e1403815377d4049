"""Named crash points for durability chaos (docs/DURABILITY.md).

A copy of ``kueue_oss_tpu/persist/hooks.py``, with the same points and
the same ``KUEUE_CRASH_*`` environment.

The crash-point harness must be able to kill the control plane at the
exact instants where write-ahead logging is allowed to lose or keep a
record — the recovery contract is defined BY those instants. Each point
is a named call site inside the persistence write paths; arming one
(directly, via :class:`kueue_oss_tpu_torch.chaos.CrashPointInjector`, or via
the ``KUEUE_CRASH_POINT`` env consumed by ``persist/crashtest.py``)
makes the ``after``-th hit of that site terminate the process with
SIGKILL — indistinguishable from a power cut, no atexit, no flush.

Points (see docs/ROBUSTNESS.md fault taxonomy):

  pre_fsync            -- a WAL record was handed to append() but dies
                          before it becomes durable (simulated
                          deterministically: the record is never
                          written, then SIGKILL)
  torn_tail            -- half of a WAL frame reaches disk durably,
                          then SIGKILL (torn write at the tail)
  post_fsync_pre_apply -- a decision intent is durable but the process
                          dies before the store mutation applies
  mid_checkpoint       -- SIGKILL after the checkpoint temp file is
                          written but before os.replace publishes it
  mid_drain            -- SIGKILL after the first N solver-plan
                          admissions committed to the store (a drain
                          interrupted halfway through its apply loop)
  sidecar_session_store -- SIGKILL inside the solver sidecar's LRU
                          session store, after a DELTA frame's dirty
                          rows were applied to the resident problem but
                          before the epoch advanced / the checksum was
                          verified (a torn session tail; RESYNC must
                          rebuild byte-identical state)

``mode="raise"`` swaps SIGKILL for a :class:`CrashPoint` exception so
in-process tests can exercise a point without a subprocess.

The fast path matters: ``crash_if`` is called from WAL appends and the
solver apply loop, so the disarmed check is one module-global read.
"""

from __future__ import annotations

import os
import signal
from typing import Optional

CRASH_POINTS = ("pre_fsync", "torn_tail", "post_fsync_pre_apply",
                "mid_checkpoint", "mid_drain", "sidecar_session_store")

KILL = "kill"
RAISE = "raise"


class CrashPoint(RuntimeError):
    """Raised instead of SIGKILL under mode="raise"."""


_armed: Optional[str] = None
_after: int = 0
_mode: str = KILL


def arm(point: str, after: int = 0, mode: str = KILL) -> None:
    """Arm `point`: its (after+1)-th hit fires."""
    global _armed, _after, _mode
    if point not in CRASH_POINTS:
        raise ValueError(f"unknown crash point {point!r}; "
                         f"one of {CRASH_POINTS}")
    if mode not in (KILL, RAISE):
        raise ValueError(f"unknown crash mode {mode!r}")
    _armed, _after, _mode = point, int(after), mode


def disarm() -> None:
    global _armed, _after
    _armed, _after = None, 0


def arm_from_env(environ=os.environ) -> Optional[str]:
    """Arm from KUEUE_CRASH_POINT / KUEUE_CRASH_AFTER / KUEUE_CRASH_MODE
    (the subprocess harness's interface). Returns the armed point."""
    point = environ.get("KUEUE_CRASH_POINT")
    if point:
        arm(point, after=int(environ.get("KUEUE_CRASH_AFTER", "0")),
            mode=environ.get("KUEUE_CRASH_MODE", KILL))
    return point


def should_fire(point: str) -> bool:
    """True when `point` is armed and its countdown just hit zero —
    consumes one countdown tick per armed hit. Call sites that need
    special pre-kill behavior (the WAL's torn write) branch on this
    and then call :func:`kill` themselves."""
    global _after, _armed
    if _armed != point:
        return False
    if _after > 0:
        _after -= 1
        return False
    _armed = None  # fire exactly once
    return True


def kill() -> None:
    """Terminate the way a power cut would (or raise under test mode)."""
    if _mode == RAISE:
        raise CrashPoint("injected crash")
    os.kill(os.getpid(), signal.SIGKILL)


def crash_if(point: str) -> None:
    """The standard call site: fire-and-kill when armed."""
    if _armed is not None and should_fire(point):
        kill()

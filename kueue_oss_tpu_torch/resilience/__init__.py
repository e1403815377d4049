"""The degradation ladder: one controller for every fault response.

A copy of ``kueue_oss_tpu/resilience/__init__.py``. The control plane's
fault responses (the solver breaker, the relaxed arm's demotion, a
device fault of the local solve, the WAL's fsync policy, the streaming
fences, the farm's backpressure) report named conditions into the
process-wide :data:`controller`:

* every subsystem has a **ladder**, a total order of rungs from fully
  featured (level 0) to the most conservative mode that still makes
  sound progress;
* a subsystem's level is the max severity of its active conditions, so
  independent faults compose monotonically;
* recovery is **hysteretic**: timed half-open re-probes all go through
  one :class:`CooldownPolicy` (one in-flight probe per condition);
* every transition lands in ``kueue_degradation_level{subsystem}``, a
  ``DEGRADATION`` event of the flight recorder and a ``DEGRADATION_ROW``
  of the cycle ledger.

The solver ladder's ``mesh`` rung is the engine's mesh arm: a mesh
drain fault reports ``mesh_broken`` and the ladder's half-open probe
re-detects the mesh after its cooldown.

The ladders (level 0 is the leftmost rung)::

    solver:      mesh -> single -> relax-off -> host
    persistence: fsync-always -> batch -> wal-off-alarm
    streaming:   wide -> structural -> off
    federation:  farm -> dedicated -> host
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

from kueue_oss_tpu_torch import metrics

# -- subsystems and their ladders -------------------------------------------

SOLVER = "solver"
PERSISTENCE = "persistence"
STREAMING = "streaming"
FEDERATION = "federation"

SUBSYSTEMS = (SOLVER, PERSISTENCE, STREAMING, FEDERATION)

#: subsystem -> ladder rungs, healthiest first. ``rung(sub)`` names the
#: rung the current level maps to (levels past the last rung clamp).
LADDERS = {
    SOLVER: ("mesh", "single", "relax-off", "host"),
    PERSISTENCE: ("fsync-always", "batch", "wal-off-alarm"),
    STREAMING: ("wide", "structural", "off"),
    FEDERATION: ("farm", "dedicated", "host"),
}

#: subsystem -> condition -> severity (the level the condition alone
#: forces). A subsystem's level is the MAX severity among its active
#: conditions: losing the mesh (1) and tripping the breaker (3) at once
#: reads level 3, and healing the breaker drops it back to 1, not 0.
SEVERITY = {
    SOLVER: {
        "mesh_broken": 1,      # mesh arm tripped; single-chip still solves
        "relax_broken": 2,     # relax arm demoted (error or disagreement)
        "device_error": 3,     # local device solve failed; host cycles
        "breaker_open": 3,     # sidecar breaker open; host cycles
    },
    PERSISTENCE: {
        "fsync_degraded": 1,   # fsync fault: dropped one durability rung
        "wal_off": 2,          # group commit also failing; WAL off + alarm
    },
    STREAMING: {
        "structural_fence": 1,  # contended roots deferred to full solves
        "stream_off": 2,        # window disarmed; batch-only until re-arm
    },
    FEDERATION: {
        "backpressure": 1,       # farm throttling this tenant (DRR deficit)
        "farm_unavailable": 2,   # farm reported backpressure to the client
    },
}


def rung_for_level(subsystem: str, level: int) -> str:
    ladder = LADDERS[subsystem]
    return ladder[min(level, len(ladder) - 1)]


# -- the one cooldown policy ------------------------------------------------


class CooldownPolicy:
    """Timed half-open re-probes, unified.

    A faulted condition gets a timestamp; once ``cooldown_s`` elapses,
    exactly one caller may claim the probe slot (``begin_probe``) and
    everybody else stays degraded until the probe reports back
    (``end_probe``). Keys are opaque — the controller uses
    ``(subsystem, condition)`` tuples.

    The probe gate (``acquire_probe``/``release_probe``) is clock-free,
    so components that keep their own injectable clocks (the solver
    breaker) can reuse the single-probe discipline while timing the
    cooldown themselves.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self.clock = clock
        self._lock = threading.Lock()
        self._faulted_at: dict = {}
        self._probing: set = set()

    def note_fault(self, key) -> None:
        """(Re)start the cooldown clock; an in-flight probe failed."""
        with self._lock:
            self._faulted_at[key] = self.clock()
            self._probing.discard(key)

    def clear(self, key) -> None:
        with self._lock:
            self._faulted_at.pop(key, None)
            self._probing.discard(key)

    def stamp(self, key) -> Optional[float]:
        return self._faulted_at.get(key)

    def set_stamp(self, key, t: float) -> None:
        """Test hook: rewind a fault stamp to simulate elapsed cooldown."""
        with self._lock:
            if key in self._faulted_at:
                self._faulted_at[key] = t

    def elapsed(self, key, cooldown_s: float) -> bool:
        at = self._faulted_at.get(key)
        return at is not None and self.clock() - at >= cooldown_s

    def probing(self, key) -> bool:
        return key in self._probing

    def acquire_probe(self, key) -> bool:
        """Clock-free single-probe gate: claim the slot or stay degraded."""
        with self._lock:
            if key in self._probing:
                return False
            self._probing.add(key)
            return True

    def release_probe(self, key) -> None:
        with self._lock:
            self._probing.discard(key)

    def begin_probe(self, key, cooldown_s: float) -> bool:
        """True iff the cooldown elapsed AND this caller won the probe
        slot. The winner must follow up with :meth:`end_probe` (or have
        the fault handler re-report, which restarts the cooldown)."""
        with self._lock:
            at = self._faulted_at.get(key)
            if at is None or self.clock() - at < cooldown_s:
                return False
            if key in self._probing:
                return False
            self._probing.add(key)
            return True

    def end_probe(self, key, success: bool) -> None:
        with self._lock:
            self._probing.discard(key)
            if success:
                self._faulted_at.pop(key, None)
            else:
                self._faulted_at[key] = self.clock()


# -- the controller ---------------------------------------------------------


class DegradationController:
    """Process-wide degradation state machine.

    Fault handlers call :meth:`report` on every condition change; the
    controller owns the level math, the cooldown/hysteresis policy, the
    metrics, and the recorder/ledger transition events. Reads
    (:meth:`level`, :meth:`active`, :meth:`snapshot`) are cheap and
    lock-light so hot paths can consult them per drain.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 history_limit: int = 512) -> None:
        self._lock = threading.Lock()
        self.history_limit = history_limit
        #: when False, transitions still track state + metrics but skip
        #: recorder/ledger events (resilience.enabled in config)
        self.enabled = True
        self.cooldowns = CooldownPolicy(clock)
        #: subsystem -> {condition: reason}
        self._conditions: dict = {s: {} for s in SUBSYSTEMS}
        #: bounded transition history (dicts, oldest first)
        self.history: list = []
        self._seq = 0

    # the policy's clock is the controller's clock: campaigns inject a
    # virtual clock here and every timed re-probe becomes deterministic
    @property
    def clock(self) -> Callable[[], float]:
        return self.cooldowns.clock

    @clock.setter
    def clock(self, fn: Callable[[], float]) -> None:
        self.cooldowns.clock = fn

    # -- reporting ----------------------------------------------------

    def report(self, subsystem: str, condition: str, active: bool, *,
               reason: str = "", cycle: int = 0) -> bool:
        """Record a condition transition; returns True iff state changed.

        Unknown subsystems/conditions raise: the severity table is the
        closed vocabulary of degraded modes.
        """
        severity = SEVERITY[subsystem][condition]
        with self._lock:
            conds = self._conditions[subsystem]
            was = condition in conds
            if bool(active) == was:
                if active:
                    # a repeat fault observation restarts the cooldown
                    # (hysteresis: probes only after a quiet period)
                    if reason:
                        conds[condition] = reason
                    self.cooldowns.note_fault((subsystem, condition))
                return False
            old_level = self._level_locked(subsystem)
            if active:
                conds[condition] = reason or condition
                self.cooldowns.note_fault((subsystem, condition))
            else:
                conds.pop(condition, None)
                self.cooldowns.clear((subsystem, condition))
            new_level = self._level_locked(subsystem)
            self._seq += 1
            entry = {
                "seq": self._seq,
                "ts": self.clock(),
                "cycle": int(cycle),
                "subsystem": subsystem,
                "condition": condition,
                "active": bool(active),
                "severity": severity,
                "old_level": old_level,
                "new_level": new_level,
                "rung": rung_for_level(subsystem, new_level),
                "reason": reason or condition,
            }
            self.history.append(entry)
            if len(self.history) > self.history_limit:
                del self.history[:len(self.history) - self.history_limit]
        metrics.degradation_level.set(subsystem, value=new_level)
        metrics.degradation_transitions_total.inc(
            subsystem, "degrade" if active else "recover")
        if self.enabled:
            self._emit(entry)
        return True

    def _emit(self, entry: dict) -> None:
        from kueue_oss_tpu_torch import obs

        arrow = "raised" if entry["active"] else "cleared"
        text = (f"{entry['subsystem']} {arrow} {entry['condition']}: "
                f"level {entry['old_level']} -> {entry['new_level']} "
                f"({entry['rung']}) — {entry['reason']}")
        if obs.recorder.enabled:
            obs.recorder.record(
                obs.DEGRADATION, obs.CYCLE_SCOPE, cycle=entry["cycle"],
                path=obs.HOST, reason=text,
                reason_slug=f"{entry['subsystem']}_{entry['condition']}",
                detail={k: entry[k] for k in
                        ("subsystem", "condition", "active", "old_level",
                         "new_level", "rung")})
        if obs.cycle_ledger.enabled:
            obs.cycle_ledger.record(
                entry["cycle"], obs.DEGRADATION_ROW, detail=dict(entry))

    # -- probes (hysteresis) ------------------------------------------

    def begin_probe(self, subsystem: str, condition: str,
                    cooldown_s: float) -> bool:
        """Claim the single half-open probe slot for an active
        condition once its cooldown elapsed. False while healthy."""
        if condition not in self._conditions[subsystem]:
            return False
        return self.cooldowns.begin_probe((subsystem, condition),
                                          cooldown_s)

    def end_probe(self, subsystem: str, condition: str,
                  success: bool) -> None:
        self.cooldowns.end_probe((subsystem, condition), success)

    # -- reads --------------------------------------------------------

    def _level_locked(self, subsystem: str) -> int:
        sev = SEVERITY[subsystem]
        conds = self._conditions[subsystem]
        return max((sev[c] for c in conds), default=0)

    def level(self, subsystem: str) -> int:
        with self._lock:
            return self._level_locked(subsystem)

    def rung(self, subsystem: str) -> str:
        return rung_for_level(subsystem, self.level(subsystem))

    def active(self, subsystem: str, condition: str) -> bool:
        return condition in self._conditions[subsystem]

    def conditions(self, subsystem: str) -> dict:
        with self._lock:
            return dict(self._conditions[subsystem])

    def levels(self) -> dict:
        with self._lock:
            return {s: self._level_locked(s) for s in SUBSYSTEMS}

    def max_level(self) -> int:
        return max(self.levels().values())

    def snapshot(self) -> dict:
        """The /api/health + dashboard rollup."""
        with self._lock:
            subs = {}
            for s in SUBSYSTEMS:
                lvl = self._level_locked(s)
                subs[s] = {
                    "level": lvl,
                    "rung": rung_for_level(s, lvl),
                    "ladder": list(LADDERS[s]),
                    "conditions": dict(self._conditions[s]),
                }
            return {
                "degraded": any(v["level"] > 0 for v in subs.values()),
                "maxLevel": max(v["level"] for v in subs.values()),
                "subsystems": subs,
                "transitions": len(self.history),
            }

    def transitions_for(self, subsystem: str) -> list:
        with self._lock:
            return [e for e in self.history if e["subsystem"] == subsystem]

    # -- lifecycle ----------------------------------------------------

    def reset(self) -> None:
        """Forget everything (tests / campaign twins). No events."""
        with self._lock:
            for s in SUBSYSTEMS:
                self._conditions[s].clear()
            self.history.clear()
            self._seq = 0
            self.cooldowns._faulted_at.clear()
            self.cooldowns._probing.clear()
        for s in SUBSYSTEMS:
            metrics.degradation_level.set(s, value=0)


#: the process-wide controller every fault handler reports into
controller = DegradationController()

#: quiet period before a degraded WAL durability policy is re-probed;
#: WriteAheadLog reads this at construction (config walRestoreCooldown)
wal_restore_cooldown_s = 60.0


def reset() -> None:
    controller.reset()


@contextlib.contextmanager
def use(ctl: DegradationController):
    """Swap the process-wide controller (chaos campaigns run their
    faulted plane and fault-free twin against separate controllers)."""
    global controller
    prev = controller
    controller = ctl
    try:
        yield ctl
    finally:
        controller = prev


def configure(cfg) -> None:
    """Apply config.ResilienceConfig to the process-wide controller."""
    global wal_restore_cooldown_s
    controller.enabled = bool(cfg.enabled)
    controller.history_limit = int(cfg.history_limit)
    wal_restore_cooldown_s = float(cfg.wal_restore_cooldown_seconds)

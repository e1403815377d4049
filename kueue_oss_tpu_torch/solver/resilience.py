"""Resilience primitives for the solver backend.

A copy of ``kueue_oss_tpu/solver/resilience.py``. The host cycle is the
reference behaviour, and the control plane must survive the solver
sidecar crashing, hanging or returning garbage without stalling an
admission round:

- ``SolverUnavailable`` is the single fault type the scheduler's routing
  sees. Transport errors, exhausted deadlines, server-reported failures
  and rejected plans all collapse into it, and the round completes on
  the host cycle.
- ``SolverHealth`` is a closed -> open -> half-open circuit breaker. The
  engine calls ``allow()`` before touching the remote backend and
  records each outcome; a tripped breaker refuses drains until its
  cooldown expires, then admits exactly one probe, which closes it or
  opens it for another cooldown.

The single-probe slot is the probe gate of the degradation ladder's
shared ``resilience.CooldownPolicy`` (``controller.cooldowns``, keyed
``(SOLVER, "breaker_open")``), so two breakers of one process share the
half-open slot, and every trip and close reports the ``breaker_open``
condition into the ladder. The cooldown's elapsed check keeps the
breaker's own injectable clock, so tests drive it without sleeping.

The breaker writes ``kueue_tpu_solver_breaker_state`` on every
transition (the recorder's breaker tags read it) and counts trips in
``kueue_tpu_solver_breaker_trips_total``; its own ``state`` and
``trips`` equal them.
"""

from __future__ import annotations

import threading
import time

from kueue_oss_tpu_torch import metrics, resilience

#: breaker states
CLOSED = "closed"
HALF_OPEN = "half-open"
OPEN = "open"
#: state -> the breaker-state gauge's value
_STATE_CODE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class SolverUnavailable(Exception):
    """The solver backend cannot produce a usable plan right now.

    Raised by ``SolverClient`` after its retries or deadline run out, and
    by the engine when the breaker is open or an imported plan fails the
    plan guard. The scheduler treats it like an unsupported problem
    shape: the admission round completes on the host cycle.
    """


class SolverHealth:
    """Circuit breaker over the remote solver backend.

    closed     -- calls flow; ``failure_threshold`` consecutive failures
                  trip the breaker open.
    open       -- calls are refused without touching the socket until
                  ``cooldown_s`` has elapsed on ``clock``.
    half-open  -- after the cooldown exactly one probe call is allowed;
                  success closes the breaker, failure re-opens it and
                  restarts the cooldown. Callers arriving during the
                  probe are refused and keep degrading to the host path.

    ``allow()`` and ``record_*()`` hold a lock, so concurrent drains see
    one consistent machine. ``trips`` counts closed / half-open -> open
    transitions (the JAX ``solver_breaker_trips_total``).
    """

    #: the shared cooldown policy's key for the probe slot
    _KEY = (resilience.SOLVER, "breaker_open")

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic) -> None:
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self.trips = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()
        # the state gauge is written only on transitions: a fresh
        # (closed) breaker must not overwrite another breaker's state

    @property
    def probing(self) -> bool:
        """Whether a half-open probe is in flight right now."""
        return resilience.controller.cooldowns.probing(self._KEY)

    def _set_state(self, state: str) -> None:
        self.state = state
        metrics.solver_breaker_state.set(value=_STATE_CODE[state])

    def allow(self) -> bool:
        """Whether a remote call may be attempted right now.

        At most one caller gets True per half-open window; it must
        follow up with record_success() or record_failure(), or with
        abandon_probe() when it ends with no outcome, to release the
        probe slot."""
        cooldowns = resilience.controller.cooldowns
        with self._lock:
            if self.state == OPEN:
                if self.clock() - self._opened_at < self.cooldown_s:
                    return False
                if not cooldowns.acquire_probe(self._KEY):
                    return False  # someone else is already probing
                self._set_state(HALF_OPEN)
                return True
            if self.state == HALF_OPEN:
                # a second drain arriving mid-probe stays degraded
                return cooldowns.acquire_probe(self._KEY)
            return True

    def record_success(self) -> None:
        ctl = resilience.controller
        with self._lock:
            ctl.cooldowns.release_probe(self._KEY)
            self.consecutive_failures = 0
            if self.state != CLOSED:
                self._set_state(CLOSED)
                ctl.report(resilience.SOLVER, "breaker_open", False,
                           reason="probe succeeded; breaker closed")

    def record_failure(self) -> None:
        with self._lock:
            resilience.controller.cooldowns.release_probe(self._KEY)
            self.consecutive_failures += 1
            if (self.state == HALF_OPEN
                    or self.consecutive_failures >= self.failure_threshold):
                self._trip()

    def abandon_probe(self) -> None:
        """Release the half-open probe slot of a drain that ended with
        no outcome (an empty backlog, or a fault before the socket): the
        breaker stays half-open and the next drain probes. The JAX
        breaker has no such release, and there such a drain keeps the
        slot until the process restarts."""
        with self._lock:
            if self.state == HALF_OPEN:
                resilience.controller.cooldowns.release_probe(self._KEY)

    def _trip(self) -> None:
        if self.state != OPEN:
            self.trips += 1
            metrics.solver_breaker_trips_total.inc()
        self._opened_at = self.clock()
        self._set_state(OPEN)
        resilience.controller.report(
            resilience.SOLVER, "breaker_open", True,
            reason=(f"breaker open after "
                    f"{self.consecutive_failures} consecutive failures"))

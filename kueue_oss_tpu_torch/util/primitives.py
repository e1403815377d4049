"""Retry backoff.

A copy of ``Backoff`` from ``kueue_oss_tpu/util/primitives.py``
(reference: pkg/util/wait/backoff.go): the scheduler's ``serve`` loop
sleeps on it after a cycle that made no progress. Cut from the copy:
``parallelize``, the hooked goroutine spawner and ``SpeedSignal``, which
nothing in the port calls, and ``Backoff``'s ``jitter`` and ``rng``,
which ``serve`` never sets (with no jitter the JAX copy draws no noise).
"""

from __future__ import annotations


class Backoff:
    """wait.Backoff analog: exponential growth with cap.

    wait_time(iteration) returns the duration for the i-th retry
    (backoff.go:44-53): initial * factor^(i-1), capped.
    """

    def __init__(self, initial: float, cap: float = 0.0,
                 factor: float = 2.0) -> None:
        if initial <= 0 or factor < 1.0:
            raise ValueError("initial must be > 0 and factor >= 1")
        self.initial = initial
        self.cap = cap or float("inf")
        self.factor = factor

    def wait_time(self, iteration: int) -> float:
        if iteration <= 0:
            return 0.0
        return min(self.initial * self.factor ** (iteration - 1),
                   self.cap)

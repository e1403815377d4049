"""The fault type the scheduler's solver routing sees.

A copy of ``SolverUnavailable`` from ``kueue_oss_tpu/solver/resilience.py``:
the solver backend cannot produce a usable plan right now, and the
admission round completes on the host cycle. The port's engine raises
it nowhere yet: it has no sidecar and no breaker (ROADMAP Queue A item
8). Cut from the copy: ``SolverHealth``, the circuit breaker.
"""

from __future__ import annotations


class SolverUnavailable(Exception):
    """The solver backend cannot produce a usable plan right now; the
    scheduler treats it like an unsupported problem shape."""

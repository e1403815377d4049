"""In-flight preemption expectations.

A copy of ``kueue_oss_tpu/util/expectations.py`` (reference:
pkg/util/expectations/store.go:30-75): the scheduler records the UIDs
of the workloads whose preemption it issued; until each eviction is
observed, later cycles must not issue a second plan for the same
preemptor nor target those workloads again. Evictions apply
synchronously here, so an expectation is observed within the call that
records it. Cut from the copy: the lock (the port's scheduler has no
threaded serve loop), and ``observed_uid`` and ``forget``, which no
caller of the port uses.
"""

from __future__ import annotations


class ExpectationsStore:
    """Tracks (owner key -> expected-to-be-preempted workload UIDs)."""

    def __init__(self, name: str = "preemption") -> None:
        self.name = name
        self._store: dict[str, set[int]] = {}

    def expect_uids(self, owner: str, uids: list[int]) -> None:
        """Record that ``owner``'s plan preempts these workloads."""
        self._store.setdefault(owner, set()).update(uids)

    def satisfied(self, owner: str) -> bool:
        """All of the owner's expected evictions were observed."""
        return not self._store.get(owner)

    def pending_uids(self) -> set[int]:
        """Union of all UIDs still expected to be evicted."""
        out: set[int] = set()
        for uids in self._store.values():
            out |= uids
        return out

    def observe(self, uid: int) -> None:
        """An eviction materialized; clear it from every plan expecting
        it."""
        for owner in list(self._store):
            self._store[owner].discard(uid)
            if not self._store[owner]:
                del self._store[owner]

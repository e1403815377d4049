"""Virtual-time replay of flight-recorder journals.

A copy of ``kueue_oss_tpu/sim/replay.py``.

A FlightRecorder journal (obs.dump_jsonl) is the ground truth of what
the live control plane decided, cycle by cycle. This module replays one
in VIRTUAL time — the clock is driven by the recorded timestamps, no
sleeps — so a post-mortem or a what-if baseline can reconstruct the
exact per-cycle decision stream on a laptop in milliseconds:

- :func:`replay` re-emits every event into a fresh ``FlightRecorder``
  whose injected clock returns each event's recorded timestamp, so the
  replayed journal is observationally identical (per-cycle decision
  kinds, reasons, ordering) to the live run;
- :func:`kind_counts_per_cycle` is the fidelity fingerprint the tests
  compare: replay of a live run must reproduce the recorded decision
  kinds per cycle, exactly;
- :func:`journal_baseline` condenses a journal into the KPI block the
  what-if report embeds as the "what actually happened" anchor.

Corrupt journal tails are already handled below us: ``obs.load_jsonl``
skips torn lines with a counted warning (and ``dump_jsonl`` writes
atomically), so a crash mid-dump can never poison replay.
"""

from __future__ import annotations

from typing import Optional

from kueue_oss_tpu_torch import obs


def load_events(path: str) -> list[obs.DecisionEvent]:
    """Tolerant journal load (delegates to obs.load_jsonl) in seq
    order — the emission order of the live run."""
    events = obs.load_jsonl(path)
    events.sort(key=lambda ev: ev.seq)
    return events


def cycles_of(events: list[obs.DecisionEvent],
              ) -> list[tuple[int, list[obs.DecisionEvent]]]:
    """Events grouped by cycle id, cycles ascending, events in seq
    order within each cycle."""
    groups: dict[int, list[obs.DecisionEvent]] = {}
    for ev in sorted(events, key=lambda e: e.seq):
        groups.setdefault(ev.cycle, []).append(ev)
    return sorted(groups.items())


def kind_counts_per_cycle(events: list[obs.DecisionEvent],
                          ) -> dict[int, dict[str, int]]:
    """cycle -> {decision kind: count}; the replay-fidelity
    fingerprint."""
    out: dict[int, dict[str, int]] = {}
    for cycle, evs in cycles_of(events):
        counts: dict[str, int] = {}
        for ev in evs:
            counts[ev.kind] = counts.get(ev.kind, 0) + 1
        out[cycle] = counts
    return out


def replay(events: list[obs.DecisionEvent],
           recorder: Optional[obs.FlightRecorder] = None,
           on_cycle=None) -> obs.FlightRecorder:
    """Re-emit a recorded decision stream into ``recorder`` in virtual
    time (the injected clock returns each event's recorded timestamp —
    replay of an hour-long run takes milliseconds and never sleeps).

    ``on_cycle(cycle, events_of_cycle)`` fires after each replayed
    cycle, so what-if passes can interleave counterfactual probes with
    the recorded timeline. Returns the recorder holding the replayed
    journal.
    """
    clock = {"now": 0.0}
    if recorder is None:
        recorder = obs.FlightRecorder(clock=lambda: clock["now"])
    else:
        recorder.clock = lambda: clock["now"]
    for cycle, evs in cycles_of(events):
        for ev in evs:
            clock["now"] = ev.ts
            recorder.record(
                ev.kind, ev.workload, cycle=ev.cycle,
                cluster_queue=ev.cluster_queue, path=ev.path,
                reason=ev.reason, reason_slug=ev.reason_slug,
                detail=ev.detail, breaker=ev.breaker)
        if on_cycle is not None:
            on_cycle(cycle, evs)
    return recorder


def journal_baseline(events: list[obs.DecisionEvent]) -> dict:
    """Condense a journal into the 'what actually happened' block the
    what-if report anchors against."""
    per_cycle = kind_counts_per_cycle(events)
    totals: dict[str, int] = {}
    for counts in per_cycle.values():
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
    span = (0.0 if not events
            else max(ev.ts for ev in events) - min(ev.ts for ev in events))
    return {
        "cycles": len(per_cycle),
        "events": len(events),
        "kinds": dict(sorted(totals.items())),
        "admitted": (totals.get(obs.ASSIGNED, 0)
                     + totals.get(obs.SOLVER_ADMITTED, 0)),
        "preempted": totals.get(obs.PREEMPTED, 0),
        "evicted": totals.get(obs.EVICTED, 0),
        "skipped": totals.get(obs.SKIPPED, 0),
        "wall_span_s": round(float(span), 6),
    }

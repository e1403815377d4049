"""Profiling + tracing.

A copy of ``kueue_oss_tpu/debugger/profiling.py``:

- `Profiler`: cProfile sessions with pstats summaries for the host
  scheduling path;
- `Tracer`: lightweight span recording with Chrome-trace JSON export
  (chrome://tracing / Perfetto-loadable), wired into the scheduler's
  cycle phases via `attach_to_scheduler`; the solver engine, the
  sidecar's imported spans and the farm write into the same ring.

Cut from the copy: the ``SamplingProfiler`` and the ``DebugServer``
HTTP endpoints that serve it (the pprof analog); no path of the port
starts them.
"""

from __future__ import annotations

import cProfile
import io
import json
import pstats
import threading
import time
from contextlib import contextmanager
from typing import Optional


class Profiler:
    """cProfile session manager (pprof 'profile' endpoint analog)."""

    def __init__(self) -> None:
        self._profile: Optional[cProfile.Profile] = None
        self._lock = threading.Lock()

    @property
    def running(self) -> bool:
        return self._profile is not None

    def start(self) -> None:
        with self._lock:
            if self._profile is not None:
                raise RuntimeError("profiler already running")
            self._profile = cProfile.Profile()
            self._profile.enable()

    def stop(self, top: int = 30, sort: str = "cumulative") -> str:
        """Stop and return a pstats text summary of the top functions."""
        with self._lock:
            if self._profile is None:
                raise RuntimeError("profiler not running")
            self._profile.disable()
            buf = io.StringIO()
            stats = pstats.Stats(self._profile, stream=buf)
            stats.sort_stats(sort).print_stats(top)
            self._profile = None
            return buf.getvalue()

    @contextmanager
    def profile(self, top: int = 30):
        """Context manager yielding a result holder; holder['report']
        has the summary after the block exits."""
        holder: dict = {}
        self.start()
        try:
            yield holder
        finally:
            holder["report"] = self.stop(top=top)


class Tracer:
    """Span recorder with Chrome-trace export.

    Bounded ring of spans; thread-safe; zero overhead when disabled.
    """

    def __init__(self, max_spans: int = 100_000,
                 clock=time.perf_counter) -> None:
        self.max_spans = max_spans
        self.clock = clock
        self.enabled = True
        self._lock = threading.Lock()
        #: ring of (name, thread id, start_us, duration_us, args) — the
        #: newest max_spans survive (an operator debugging a current
        #: stall needs the RECENT activity, not warm-up)
        self._spans: list[tuple] = []
        self._next = 0
        #: external span sources (sidecar solves, followers, the farm)
        #: get stable SYNTHETIC track ids so their spans never
        #: interleave with host threads on one Chrome-trace track.
        #: Small ids are safe: host tids are pthread pointers.
        self._tracks: dict[str, int] = {}
        self._track_meta: dict[str, dict] = {}
        self._next_track = 2

    @contextmanager
    def span(self, name: str, **args):
        if not self.enabled:
            yield
            return
        t0 = self.clock()
        try:
            yield
        finally:
            dur = self.clock() - t0
            self._push((name, threading.get_ident(),
                        int(t0 * 1e6), int(dur * 1e6), args or None))

    def track(self, source: str, **meta) -> int:
        """Stable synthetic track id for an external span source
        (``"sidecar:tenant-a"``, ``"farm"``, ``"follower:1"``).
        ``meta`` (process/tenant tags) accumulates onto the track and
        exports as Chrome thread_name metadata."""
        with self._lock:
            tid = self._tracks.get(source)
            if tid is None:
                tid = self._tracks[source] = self._next_track
                self._next_track += 1
            if meta:
                self._track_meta.setdefault(source, {}).update(meta)
            return tid

    def add_span(self, name: str, ts_us: int, dur_us: int,
                 tid: Optional[int] = None,
                 source: Optional[str] = None, **args) -> None:
        """Record an externally-timed span (e.g. a sidecar solve whose
        timing arrived over the wire) into the same ring, so host and
        remote activity export as one Chrome-trace timeline. Pass
        ``source`` for external spans — they land on that source's own
        synthetic track instead of the CALLER's thread track (merged
        remote spans used to interleave with host spans)."""
        if not self.enabled:
            return
        if tid is None:
            tid = (self.track(source) if source is not None
                   else threading.get_ident())
        self._push((name, tid, int(ts_us), int(dur_us), args or None))

    def _push(self, entry: tuple) -> None:
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(entry)
            else:
                self._spans[self._next % self.max_spans] = entry
            self._next += 1

    def spans(self) -> list[tuple]:
        with self._lock:
            if len(self._spans) < self.max_spans:
                return list(self._spans)
            cut = self._next % self.max_spans
            return self._spans[cut:] + self._spans[:cut]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._next = 0

    def durations_ms(self, name: str) -> list[float]:
        return [dur / 1000 for (n, _, _, dur, _) in self.spans()
                if n == name]

    def chrome_trace(self, spans: Optional[list] = None) -> str:
        """Chrome-trace JSON ('X' complete events) — loadable in
        chrome://tracing or Perfetto alongside a JAX device trace.
        Synthetic source tracks lead with 'M' thread_name metadata so
        the timeline labels them by source + tenant/process tags."""
        with self._lock:
            tracks = sorted(self._tracks.items(), key=lambda kv: kv[1])
            meta = {s: dict(m) for s, m in self._track_meta.items()}
        events = []
        for src, tid in tracks:
            args = {"name": src}
            args.update(meta.get(src, {}))
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": args})
        for name, tid, ts, dur, args in (self.spans() if spans is None
                                         else spans):
            ev = {"name": name, "ph": "X", "pid": 1, "tid": tid,
                  "ts": ts, "dur": dur, "cat": "scheduler"}
            if args:
                ev["args"] = args
            events.append(ev)
        return json.dumps({"traceEvents": events,
                           "displayTimeUnit": "ms"})


def attach_to_scheduler(scheduler, tracer: Tracer) -> None:
    """Wrap the scheduler's cycle phases in tracer spans: one
    'schedule' span per cycle with nested 'snapshot' / 'nominate'
    phases (the reference logs per-phase durations at V(2)). The tracer
    is also published on the scheduler so the solver engine's drain and
    imported sidecar spans land in the SAME ring — one merged timeline
    keyed by cycle id."""
    scheduler.tracer = tracer
    orig_schedule = scheduler.schedule
    orig_nominate = scheduler._nominate

    def schedule(now=None):
        with tracer.span("schedule", cycle=scheduler.cycle_count + 1):
            return orig_schedule(now)

    def nominate(heads, snapshot, now):
        with tracer.span("nominate", heads=len(heads)):
            return orig_nominate(heads, snapshot, now)

    scheduler.schedule = schedule
    scheduler._nominate = nominate

"""Device telemetry: compile accounting, transfer ledger, deep capture.

A copy of ``kueue_oss_tpu/obs/devtel.py`` on PyTorch and CUDA. The
device-side collector the solver fabric threads through
(docs/OBSERVABILITY.md "Device telemetry & fabric tracing"):

- :class:`CompileDetector` — first-call detection per (kernel, arm, pow2
  shape-bucket), with the JAX keys and the ``xla_compile`` span name.
  On the card a first call in a bucket is where the caching allocator
  grows and, for the hand kernels, where their library loads, so its
  wall must not feed the router's EMA either. With the detector enabled
  the engine's arm router takes its verdict per shape bucket instead of
  discarding each arm's first sample.
- transfer ledger — ``DeviceResidentProblem``'s byte counters fold into
  one ``solver_transfer_bytes_total{direction,arm,tenant}`` family, plus
  per-drain watermark gauges: the CUDA caching allocator's
  ``allocated_bytes.all.current`` for the engine's device, and the
  resident-problem byte bookkeeping, which is portable and also runs on
  the CPU.
- :class:`DeepCapture` — tail-based deep capture: a bounded
  ``torch.profiler.profile`` session (CPU and CUDA activities) triggered
  when an SLO burn alert fires or the PhaseRegressionDetector trips; its
  Chrome trace lands in the capture's directory. One capture in flight,
  a cooldown from capture start.

The process-wide :data:`collector` follows the obs.recorder idiom;
``obs.configure()`` applies ``observability.devtel`` from config.
Everything is clock-injectable for virtual-time tests.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from kueue_oss_tpu_torch import metrics
from kueue_oss_tpu_torch.resilience import CooldownPolicy

#: device-delta counter name -> transfer direction (the unification of
#: solver/delta.py's scattered byte counters; counts are not bytes and
#: stay out of the transfer family)
TRANSFER_DIRECTIONS = {
    "donated_update_bytes": "h2d",
    "full_upload_bytes": "h2d",
    "avoided_copy_bytes": "avoided",
}


def shape_bucket(n: int) -> str:
    """Pow2 ceiling bucket for a solve's row count (the JAX key: XLA
    recompiles per padded shape and the engine pads to pow2-ish
    targets). On the card two solves in one bucket share their padded
    allocation sizes in the caching allocator."""
    if n <= 1:
        return "1" if n == 1 else "0"
    return str(1 << (int(n) - 1).bit_length())


def device_memory_stats(device=None) -> dict[str, int]:
    """Bytes the CUDA caching allocator holds for tensors on ``device``
    (``memory_stats(device)["allocated_bytes.all.current"]``), keyed by
    the device index. Empty for a CPU device or when CUDA is absent.
    Never raises — devtel must not be able to break a drain."""
    try:
        import torch

        if device is None or torch.device(device).type != "cuda":
            return {}
        dev = torch.device(device)
        index = dev.index if dev.index is not None else (
            torch.cuda.current_device())
        stats = torch.cuda.memory_stats(index)
        if "allocated_bytes.all.current" not in stats:
            return {}
        return {str(index): int(stats["allocated_bytes.all.current"])}
    except Exception:
        return {}


class CompileDetector:
    """First-call detection on the engine's solves (the JAX compile
    detector; on the card the first call in a bucket is the one that
    grows the caching allocator and loads the hand kernels).

    A (kernel, arm, shape-bucket) triple seen for the first time is a
    compile-bearing call: its wall upper-bounds compile time (the wall
    includes the traced execution) and must not feed the router's EMA.
    ``forget`` re-arms keys when the router resets an arm (mesh
    refresh, demotion) so the next solve is treated as fresh again —
    mirroring the legacy ``_arm_warm.discard`` touchpoints.
    """

    def __init__(self, tracer=None) -> None:
        self.tracer = tracer
        self._lock = threading.Lock()
        self._seen: set = set()
        #: total compile events since construction (bench/status)
        self.compiles = 0
        self._events: list = []

    def observe_solve(self, kernel: str, arm: str, n: int,
                      wall_s: float) -> bool:
        """Record one timed solve; True iff it carried a compile."""
        bucket = shape_bucket(n)
        key = (kernel, arm, bucket)
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            self.compiles += 1
            self._events.append({"kernel": kernel, "arm": arm,
                                 "bucket": bucket,
                                 "wallSeconds": round(float(wall_s), 6)})
        metrics.solver_compiles_total.inc(kernel, arm, bucket)
        metrics.solver_compile_seconds.observe(value=float(wall_s))
        tracer = self.tracer
        if tracer is not None and getattr(tracer, "enabled", False):
            dur_us = int(float(wall_s) * 1e6)
            now_us = int(tracer.clock() * 1e6)
            tracer.add_span("xla_compile", now_us - dur_us, dur_us,
                            source="devtel", kernel=kernel, arm=arm,
                            bucket=bucket)
        return True

    def seen(self, kernel: str, arm: str, n: int) -> bool:
        with self._lock:
            return (kernel, arm, shape_bucket(n)) in self._seen

    def forget(self, kernel: Optional[str] = None,
               arm: Optional[str] = None) -> None:
        """Drop seen keys matching kernel/arm (None = wildcard)."""
        with self._lock:
            self._seen = {k for k in self._seen
                          if not ((kernel is None or k[0] == kernel)
                                  and (arm is None or k[1] == arm))}

    def drain_events(self) -> list:
        """Pop compile events since the last drain (ledger-row field)."""
        with self._lock:
            out, self._events = self._events, []
            return out

    def reset(self) -> None:
        with self._lock:
            self._seen.clear()
            self._events.clear()
            self.compiles = 0


class DeepCapture:
    """Tail-based deep capture with one in-flight slot + cooldown.

    ``trigger`` starts a bounded capture session unless the capturer
    is disarmed, busy, or cooling down (:class:`CooldownPolicy` keyed
    ``("devtel", "capture")`` — the stamp is set at capture START, so
    back-to-back alert storms yield one artifact per cooldown window).
    A capture writes a ``capture.json`` marker into its own directory
    beside the checkpoints and, when ``use_profiler`` is set, brackets a
    ``torch.profiler.profile`` session (CPU activity, and CUDA activity
    when the card is there) whose Chrome trace it exports to
    ``trace.json`` in that directory when the capture ends.
    ``poll`` finishes the session once ``max_seconds`` elapses; POST
    /api/telemetry can stop it early. All timing flows through the
    injected clock.
    """

    KEY = ("devtel", "capture")
    TRIGGERS = ("slo_burn", "phase_regression", "manual")

    def __init__(self, dir: Optional[str] = None,
                 max_seconds: float = 5.0,
                 cooldown_s: float = 300.0,
                 use_profiler: bool = False,
                 clock=time.monotonic) -> None:
        self.dir = dir
        self.max_seconds = float(max_seconds)
        self.cooldown_s = float(cooldown_s)
        self.use_profiler = bool(use_profiler)
        self.cooldowns = CooldownPolicy(clock)
        self.armed = True
        self._lock = threading.Lock()
        self._active: Optional[dict] = None
        #: the running torch.profiler.profile of the capture in flight
        self._prof = None
        self._seq = 0
        self.history: list = []

    @property
    def clock(self):
        return self.cooldowns.clock

    @clock.setter
    def clock(self, clock) -> None:
        self.cooldowns.clock = clock

    def trigger(self, reason: str, detail: Optional[dict] = None) -> bool:
        """Try to start a capture; False (with a counted outcome) when
        suppressed. Never raises."""
        reason = reason if reason in self.TRIGGERS else "manual"
        with self._lock:
            if not self.armed:
                metrics.solver_deep_captures_total.inc(reason, "disarmed")
                return False
            if self._active is not None:
                metrics.solver_deep_captures_total.inc(
                    reason, "suppressed_busy")
                return False
            cp = self.cooldowns
            if (cp.stamp(self.KEY) is not None
                    and not cp.elapsed(self.KEY, self.cooldown_s)):
                metrics.solver_deep_captures_total.inc(
                    reason, "suppressed_cooldown")
                return False
            cp.note_fault(self.KEY)  # cooldown runs from capture START
            self._seq += 1
            rec = {"seq": self._seq, "reason": reason,
                   "startedAt": cp.clock(), "detail": detail or {},
                   "profiler": False, "path": None}
            self._active = rec
        self._materialize(rec)
        metrics.solver_deep_captures_total.inc(reason, "started")
        return True

    def _materialize(self, rec: dict) -> None:
        """Create the artifact directory + start the profiler. Outside
        the lock — filesystem/profiler faults degrade to a marker-less
        capture, never to a failed trigger."""
        if self.dir:
            path = os.path.join(
                self.dir, f"capture-{rec['seq']:03d}-{rec['reason']}")
            try:
                os.makedirs(path, exist_ok=True)
                rec["path"] = path
                self._write_marker(rec)
            except OSError:
                rec["path"] = None
        if self.use_profiler and rec["path"]:
            prof = None
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.start()
                self._prof = prof
                rec["profiler"] = True
            except Exception:
                # a profiler that started and then failed must not stay on
                _stop_quietly(prof)
                self._prof = None
                rec["profiler"] = False

    def _write_marker(self, rec: dict) -> None:
        try:
            with open(os.path.join(rec["path"], "capture.json"),
                      "w") as fh:
                json.dump(rec, fh, indent=2, sort_keys=True,
                          default=str)
        except OSError:
            pass

    def poll(self, now: Optional[float] = None) -> bool:
        """Finish the in-flight capture once its budget elapses; True
        iff a capture was closed by this call."""
        with self._lock:
            rec = self._active
            if rec is None:
                return False
            t = self.clock() if now is None else now
            if t - rec["startedAt"] < self.max_seconds:
                return False
            self._active = None
        self._finish(rec, t)
        return True

    def stop(self) -> bool:
        """Force-finish the in-flight capture (POST /api/telemetry)."""
        with self._lock:
            rec = self._active
            if rec is None:
                return False
            self._active = None
        self._finish(rec, self.clock())
        return True

    def _finish(self, rec: dict, t: float) -> None:
        prof, self._prof = self._prof, None
        if rec.get("profiler") and prof is not None:
            try:
                prof.stop()
                trace = os.path.join(rec["path"], "trace.json")
                prof.export_chrome_trace(trace)
                rec["trace"] = trace
            except Exception:
                _stop_quietly(prof)
        rec["endedAt"] = t
        rec["durationSeconds"] = round(max(0.0, t - rec["startedAt"]), 6)
        if rec.get("path"):
            self._write_marker(rec)
        with self._lock:
            self.history.append(rec)
            del self.history[:-16]

    def active(self) -> Optional[dict]:
        with self._lock:
            return dict(self._active) if self._active else None

    def status(self) -> dict:
        cp = self.cooldowns
        stamp = cp.stamp(self.KEY)
        remaining = 0.0
        if stamp is not None:
            remaining = max(0.0, self.cooldown_s - (cp.clock() - stamp))
        with self._lock:
            return {"armed": self.armed,
                    "active": dict(self._active) if self._active
                    else None,
                    "maxSeconds": self.max_seconds,
                    "cooldownSeconds": self.cooldown_s,
                    "cooldownRemainingSeconds": round(remaining, 3),
                    "useProfiler": self.use_profiler,
                    "dir": self.dir,
                    "captures": [dict(r) for r in self.history]}

    def reset(self) -> None:
        self.stop()
        with self._lock:
            self.history.clear()
            self._seq = 0
            self.armed = True
        self.cooldowns.clear(self.KEY)


def _stop_quietly(prof) -> None:
    if prof is None:
        return
    try:
        prof.stop()
    except Exception:
        pass


class DeviceTelemetry:
    """The collector the solver fabric threads through.

    Disabled by default (``enabled`` gates every hook to a cheap
    early-out, the bench twin's overhead contract); ``configure``
    applies a config.DevTelConfig. The engine calls ``observe_solve``
    from its arm-wall router, ``note_transfers``/``sample_residency``
    from its ledger path, and ``on_drain`` once per drain — which
    polls the phase-regression detector and ticks the capture budget.
    An SLO sink (registered on the process-wide engine when capture is
    enabled) fires captures on burn-alert transitions.
    """

    def __init__(self, clock=time.monotonic) -> None:
        self.enabled = False
        self.compile_enabled = True
        self.transfer_enabled = True
        self.hbm_enabled = True
        self.capture_enabled = False
        self.compiles = CompileDetector()
        self.capture = DeepCapture(clock=clock)
        self._lock = threading.Lock()
        #: direction -> total bytes (the bench/status aggregate of the
        #: metric family, kept label-free on purpose)
        self.transfer_bytes: dict = {}
        self.hbm_resident_bytes = 0
        self._sink_registered = False

    # -- wiring ------------------------------------------------------------

    @property
    def tracer(self):
        return self.compiles.tracer

    @tracer.setter
    def tracer(self, tracer) -> None:
        self.compiles.tracer = tracer

    def _slo_sink(self, transition: str, payload: dict) -> None:
        if transition == "fired" and self.enabled and self.capture_enabled:
            self.capture.trigger("slo_burn", {
                "scope": payload.get("scope"),
                "key": payload.get("key"),
                "exemplar": payload.get("exemplar")})

    def attach_alerts(self) -> None:
        """Register the capture trigger on the process-wide SLO engine
        (idempotent)."""
        if self._sink_registered:
            return
        from kueue_oss_tpu_torch.obs.health import slo

        slo.add_sink(self._slo_sink)
        self._sink_registered = True

    def detach_alerts(self) -> None:
        if not self._sink_registered:
            return
        from kueue_oss_tpu_torch.obs.health import slo

        slo.remove_sink(self._slo_sink)
        self._sink_registered = False

    # -- engine hooks ------------------------------------------------------

    def observe_solve(self, kernel: str, arm: str, n: int,
                      wall_s: float) -> bool:
        """Compile verdict for one timed solve (False when disabled —
        the engine then falls back to its legacy warm-set)."""
        if not (self.enabled and self.compile_enabled):
            return False
        return self.compiles.observe_solve(kernel, arm, n, wall_s)

    def forget(self, kernel: Optional[str] = None,
               arm: Optional[str] = None) -> None:
        if self.enabled and self.compile_enabled:
            self.compiles.forget(kernel, arm)

    def note_transfers(self, arm: str, tenant: str,
                       device_delta: dict) -> None:
        """Fold one drain's device-counter deltas into the unified
        transfer family."""
        if not (self.enabled and self.transfer_enabled):
            return
        for name, nbytes in (device_delta or {}).items():
            direction = TRANSFER_DIRECTIONS.get(name)
            if direction is None or not nbytes:
                continue
            metrics.solver_transfer_bytes_total.inc(
                direction, arm, tenant, by=float(nbytes))
            with self._lock:
                self.transfer_bytes[direction] = (
                    self.transfer_bytes.get(direction, 0) + int(nbytes))

    def note_wire(self, arm: str, tenant: str, nbytes: int) -> None:
        """One request frame's bytes on the sidecar wire (direction
        ``tx``)."""
        if not (self.enabled and self.transfer_enabled) or not nbytes:
            return
        metrics.solver_transfer_bytes_total.inc(
            "tx", arm, tenant, by=float(nbytes))
        with self._lock:
            self.transfer_bytes["tx"] = (
                self.transfer_bytes.get("tx", 0) + int(nbytes))

    def sample_residency(self, resident_bytes: int, device=None) -> dict:
        """Per-drain device watermark: gauges + the extra ledger-row
        device fields. Portable bookkeeping always; the CUDA caching
        allocator's bytes for ``device`` (the engine's) when it is a
        card."""
        if not (self.enabled and self.hbm_enabled):
            return {}
        self.hbm_resident_bytes = int(resident_bytes)
        metrics.solver_hbm_resident_bytes.set(value=float(resident_bytes))
        out = {"hbm_resident_bytes": int(resident_bytes)}
        stats = device_memory_stats(device)
        for dev, in_use in stats.items():
            metrics.solver_hbm_bytes_in_use.set(dev, value=float(in_use))
        if stats:
            out["hbm_bytes_in_use"] = sum(stats.values())
        return out

    def on_drain(self) -> None:
        """Once per engine drain: trip captures on phase regressions
        and tick the in-flight capture's budget."""
        if not self.enabled:
            return
        if self.capture_enabled and self.capture.armed:
            if self.capture.active() is None:
                from kueue_oss_tpu_torch.obs.health import phase_regression

                regressing = phase_regression.regressing()
                if regressing:
                    self.capture.trigger("phase_regression",
                                         {"phases": regressing[:4]})
            self.capture.poll()

    # -- config / surface --------------------------------------------------

    def configure(self, cfg, capture_dir: Optional[str] = None) -> None:
        """Apply a config.DevTelConfig (obs.configure calls this).
        ``capture_dir`` defaults captures beside the checkpoints when
        the config names no directory of its own."""
        self.enabled = bool(cfg.enabled)
        self.compile_enabled = bool(cfg.compile_accounting)
        self.transfer_enabled = bool(cfg.transfer_ledger)
        self.hbm_enabled = bool(cfg.hbm_watermarks)
        self.capture_enabled = bool(cfg.capture_enabled)
        self.capture.max_seconds = float(cfg.capture_max_seconds)
        self.capture.cooldown_s = float(cfg.capture_cooldown_seconds)
        self.capture.use_profiler = bool(cfg.capture_use_profiler)
        self.capture.dir = cfg.capture_dir or capture_dir
        if self.enabled and self.capture_enabled:
            self.attach_alerts()
        else:
            self.detach_alerts()

    def status(self) -> dict:
        """The GET /api/telemetry report."""
        with self._lock:
            transfers = dict(self.transfer_bytes)
        return {"enabled": self.enabled,
                "compile": {"enabled": self.compile_enabled,
                            "events": self.compiles.compiles},
                "transfer": {"enabled": self.transfer_enabled,
                             "bytes": transfers},
                "hbm": {"enabled": self.hbm_enabled,
                        "residentBytes": self.hbm_resident_bytes},
                "capture": dict(self.capture.status(),
                                enabled=self.capture_enabled)}

    def reset(self) -> None:
        """Test helper (the recorder idiom): back to the disabled
        defaults, sink detached, detector/capture state dropped."""
        self.detach_alerts()
        self.enabled = False
        self.compile_enabled = True
        self.transfer_enabled = True
        self.hbm_enabled = True
        self.capture_enabled = False
        self.compiles.reset()
        self.capture.reset()
        self.capture.dir = None
        self.capture.max_seconds = 5.0
        self.capture.cooldown_s = 300.0
        self.capture.use_profiler = False
        with self._lock:
            self.transfer_bytes.clear()
        self.hbm_resident_bytes = 0


#: process-wide collector (the obs.recorder idiom); obs.configure()
#: applies observability.devtel onto it
collector = DeviceTelemetry()


def reset() -> None:
    collector.reset()

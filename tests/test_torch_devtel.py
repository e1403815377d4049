"""The port's device telemetry (``kueue_oss_tpu_torch/obs/devtel.py``)
against the JAX package's on the CPU.

Tolerance 0: the compile detector's verdicts per (kernel, arm, pow2
shape bucket) and their series, the engine's compile events over a lean
flood with finishes and the TAS store, the transfer ledger's bytes by
direction over those runs, and the deep capture's trigger, suppression,
cooldown and finish on an injected clock. On the card the watermark
reads the CUDA caching allocator (chip_smoke.py phase 23); on the CPU
``device_memory_stats`` is empty and never raises, and a capture with
the profiler on writes a Chrome trace and leaves no profiler running.
"""

import torch_threads  # noqa: F401  (one torch thread per worker)

import json
import os

import pytest
import torch
import torch_obs_pins as O

from kueue_oss_tpu import metrics as jax_metrics
from kueue_oss_tpu.obs import devtel as jax_devtel
from kueue_oss_tpu_torch import metrics as port_metrics
from kueue_oss_tpu_torch.obs import devtel as port_devtel

J, T = "kueue_oss_tpu", "kueue_oss_tpu_torch"


@pytest.mark.parametrize("case", ["lean", "tas"])
def test_engine_compile_events_and_transfers_match_jax(case):
    want, got = O.capture(case, J), O.capture(case, T)
    assert got["compiles"] == want["compiles"]
    assert want["compiles"]
    assert got["transfer"] == want["transfer"]
    assert want["transfer"].get("h2d", 0) > 0


def test_compile_detector_matches_jax():
    def drive(devtel, metrics):
        metrics.reset_all()
        det = devtel.CompileDetector()
        out = [det.observe_solve(k, a, n, 0.5)
               for k, a, n in (("lean", "single", 600), ("lean", "single",
                                                           1000),
                               ("lean", "single", 1100),
                               ("full", "single", 1),
                               ("lean", "relax", 0))]
        out.append(det.seen("lean", "single", 513))
        det.forget(arm="relax")
        out.append(det.observe_solve("lean", "relax", 0, 0.25))
        det.forget(kernel="lean")
        out.append(det.seen("lean", "single", 600))
        out.append([(e["kernel"], e["arm"], e["bucket"])
                    for e in det.drain_events()])
        out.append(det.compiles)
        out.append([devtel.shape_bucket(n) for n in (0, 1, 2, 3, 1024,
                                                     1025)])
        lines = [x for x in metrics.registry.render().splitlines()
                 if "compile" in x and not x.startswith("#")]
        metrics.reset_all()
        return out, lines

    assert drive(port_devtel, port_metrics) == drive(jax_devtel,
                                                     jax_metrics)


def _capture_run(devtel, tmp):
    t = [100.0]
    cap = devtel.DeepCapture(dir=tmp, max_seconds=2.0, cooldown_s=10.0,
                             clock=lambda: t[0])
    out = [cap.trigger("slo_burn", {"key": "cq"}),
           cap.trigger("manual"),              # busy
           cap.poll()]                          # budget not spent
    t[0] += 3.0
    out.append(cap.poll())                      # finished
    out.append(cap.trigger("phase_regression"))  # cooling down
    t[0] += 10.0
    out.append(cap.trigger("bogus"))            # counted as manual
    out.append(cap.stop())
    cap.armed = False
    out.append(cap.trigger("manual"))
    st = cap.status()
    out.append([{k: v for k, v in r.items() if k != "path"}
                for r in st["captures"]])
    out.append(sorted(os.listdir(tmp)))
    return out


def test_deep_capture_matches_jax(tmp_path):
    jax_metrics.reset_all()
    port_metrics.reset_all()
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = _capture_run(jax_devtel, str(tmp_path / "j"))
    got = _capture_run(port_devtel, str(tmp_path / "p"))
    assert got == want

    def lines(m):
        return [x for x in m.registry.render().splitlines()
                if x.startswith("kueue_tpu_solver_deep_captures_total")]

    assert lines(port_metrics) == lines(jax_metrics)
    jax_metrics.reset_all()
    port_metrics.reset_all()


def test_profiled_capture_writes_a_chrome_trace_and_stops(tmp_path):
    cap = port_devtel.DeepCapture(dir=str(tmp_path), max_seconds=0.0,
                                  use_profiler=True)
    assert cap.trigger("manual")
    torch.ones(64).sum()
    assert cap.poll()
    rec = cap.status()["captures"][-1]
    assert rec["profiler"] is True
    with open(rec["trace"]) as fh:
        trace = json.load(fh)
    assert trace["traceEvents"]
    assert not torch.autograd.profiler._is_profiler_enabled
    # a profiler that cannot start degrades to a marker-only capture
    cap2 = port_devtel.DeepCapture(dir=None, use_profiler=True)
    assert cap2.trigger("manual") and cap2.stop()
    assert cap2.status()["captures"][-1]["profiler"] is False


def test_memory_stats_never_raise_and_residency_on_the_cpu():
    assert port_devtel.device_memory_stats("cpu") == {}
    assert port_devtel.device_memory_stats(None) == {}
    if not torch.cuda.is_available():
        assert port_devtel.device_memory_stats("cuda") == {}
    port_metrics.reset_all()
    tel = port_devtel.DeviceTelemetry()
    assert tel.sample_residency(4096, "cpu") == {}
    tel.enabled = True
    assert tel.sample_residency(4096, "cpu") == {
        "hbm_resident_bytes": 4096}
    assert port_metrics.solver_hbm_resident_bytes.value() == 4096.0
    tel.note_transfers("single", "", {"full_upload_bytes": 10,
                                      "avoided_copy_bytes": 4,
                                      "donated_full_syncs": 1})
    tel.note_wire("remote", "t", 7)
    assert tel.transfer_bytes == {"h2d": 10, "avoided": 4, "tx": 7}
    port_metrics.reset_all()


def test_configure_status_and_phase_regression_trigger_match_jax(tmp_path):
    from kueue_oss_tpu.config import configuration as jax_cfg
    from kueue_oss_tpu_torch.config import configuration as port_cfg

    def drive(pkg, cfg_mod):
        obs, metrics, devtel, _ = O.modules(pkg)
        O.reset(pkg)
        try:
            cfg = cfg_mod.DevTelConfig(enabled=True, capture_enabled=True,
                                       capture_max_seconds=0.0,
                                       capture_dir=str(tmp_path / pkg))
            tel = devtel.collector
            tel.configure(cfg)
            t = [0.0]
            tel.capture.clock = lambda: t[0]
            for _ in range(25):
                obs.phase_regression.feed("solver", {"solve": 0.01})
            for _ in range(6):
                obs.phase_regression.feed("solver", {"solve": 0.2})
            tel.on_drain()
            st = tel.status()
            for r in st["capture"]["captures"]:
                r.pop("path", None)
            st["capture"].pop("dir")
            sinks = len(obs.slo_engine.sinks)
            return st, sinks
        finally:
            O.reset(pkg)

    want = drive(J, jax_cfg)
    assert drive(T, port_cfg) == want
    assert want[0]["capture"]["captures"][0]["reason"] == (
        "phase_regression")

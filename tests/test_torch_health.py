"""The port's SLO engine, webhook sink, phase-regression detector and
starvation watchdog (``kueue_oss_tpu_torch/obs/health.py``) against the
JAX package on the CPU.

Tolerance 0: the same admissions fed to both engines on an injected
clock give the same burn rates, alert transitions, exemplars, sink
deliveries, gauges and reports; the scheduler's and the engine's
admissions feed the same SLO report; the detector flags the same
phases; the watchdog reports the same oldest pending workloads.
"""

import torch_threads  # noqa: F401  (one torch thread per worker)

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest
import torch_obs_pins as O

from kueue_oss_tpu import metrics as jax_metrics
from kueue_oss_tpu.obs import health as jax_health
from kueue_oss_tpu_torch import metrics as port_metrics
from kueue_oss_tpu_torch.obs import health as port_health

J, T = "kueue_oss_tpu", "kueue_oss_tpu_torch"


def _drive_slo(health, metrics, sink_url=None):
    metrics.reset_all()
    eng = health.SLOEngine(target=0.9, threshold_s=10.0,
                           fast_window_s=60.0, slow_window_s=600.0,
                           burn_threshold=2.0, clock=lambda: 0.0)
    got = []
    eng.add_sink(lambda tr, payload: got.append((tr, payload)))
    if sink_url:
        eng.set_config_sink(health.WebhookSink(sink_url, timeout_s=2.0))
    reports = []
    for step in range(40):
        now = 30.0 * step
        bad = 8 <= step < 20
        for i in range(3):
            eng.observe_admission(f"cq{i % 2}", 50.0 if bad else 1.0,
                                  priority=i, now=now, cycle=step,
                                  workload=f"ns/w{step}-{i}")
        eng.advance(now + 5.0)
        if step % 4 == 3:
            reports.append(eng.evaluate())
    reports.append(eng.evaluate(now=5000.0))
    eng.reconfigure(target=0.5, threshold_s=1.0, fast_window_s=30.0,
                    slow_window_s=60.0, burn_threshold=1.0,
                    starvation_threshold_s=5.0)
    reports.append(eng.evaluate())
    lines = [x for x in metrics.registry.render().splitlines()
             if x.startswith("kueue_slo")]
    metrics.reset_all()
    return reports, got, lines


def test_slo_engine_matches_jax():
    want = _drive_slo(jax_health, jax_metrics)
    got = _drive_slo(port_health, port_metrics)
    assert got == want
    transitions = [t for t, _ in want[1]]
    assert "fired" in transitions and "cleared" in transitions


def test_webhook_deliveries_match_jax():
    bodies = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            bodies.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/hook"
        _drive_slo(jax_health, jax_metrics, url)
        want, bodies[:] = list(bodies), []
        _drive_slo(port_health, port_metrics, url)
        assert bodies == want and want
        # a dead receiver is counted, never raised
        dead = port_health.WebhookSink("http://127.0.0.1:9/x",
                                       timeout_s=0.2)
        eng = port_health.SLOEngine(threshold_s=0.0, burn_threshold=0.0,
                                    clock=lambda: 1.0)
        eng.set_config_sink(dead)
        eng.observe_admission("cq", 5.0, now=1.0)
        eng.evaluate()
        # one failed delivery per firing key (the CQ and the priority)
        assert port_metrics.slo_alert_deliveries_total.value("error") == 2
    finally:
        srv.shutdown()
        srv.server_close()
        port_metrics.reset_all()


@pytest.mark.parametrize("case", ["lean", "storm_host"])
def test_slo_report_of_a_run_matches_jax(case):
    want, got = O.capture(case, J), O.capture(case, T)
    assert got["slo"] == want["slo"]
    assert want["slo"]["slis"]


def test_phase_regression_detector_matches_jax():
    def drive(health, metrics):
        metrics.reset_all()
        det = health.PhaseRegressionDetector(ratio=2.0, min_samples=5)
        flagged = []
        for i in range(40):
            wall = 0.01 if i < 25 else 0.05
            det.feed("host", {"snapshot": wall, "entries": 0.002,
                              "bad": "x"})
            flagged.append(det.regressing())
        lines = [x for x in metrics.registry.render().splitlines()
                 if x.startswith("kueue_cycle_phase")]
        metrics.reset_all()
        return flagged, lines

    want = drive(jax_health, jax_metrics)
    assert drive(port_health, port_metrics) == want
    assert want[0][-1]


def test_starvation_watchdog_matches_jax():
    import torch_scheduler_pins as P

    def drive(package, health, metrics):
        types, store_cls, make, _ = package
        store = O._lean_store(types, store_cls)
        O._flood(types, store, 40)
        sched, _ = make(store, False)
        sched.schedule(now=10.0)
        eng = health.SLOEngine(starvation_threshold_s=20.0,
                               clock=lambda: 0.0)
        metrics.reset_all()
        rep = eng.evaluate(now=50.0, queues=sched.queues)
        lines = [x for x in metrics.registry.render().splitlines()
                 if x.startswith("kueue_starvation")]
        metrics.reset_all()
        return (rep["starvation"], lines,
                health.oldest_pending(sched.queues, 50.0))

    want = drive(P.jax_package(), jax_health, jax_metrics)
    got = drive(P.port_package("cpu"), port_health, port_metrics)
    assert got == want
    assert any(s["starved"] for s in want[0])

"""The port's flight recorder (``kueue_oss_tpu_torch/obs/__init__.py``)
and journal replay (``sim/replay.py``) against the JAX package on the
CPU, on the same seeded stores.

Tolerance 0: every decision event (kind, workload, cycle, ClusterQueue,
path, reason, slug, breaker tag and detail; not its wall timestamp) in
order, each workload's ``explain`` chain, the per-cycle ``decisions``
view and the replay's kind counts per cycle, over a lean flood with
finishes drained on the device, the TAS store through
``Scheduler(solver="auto")``, and the preemption storm through host
cycles and through the FULL drain. A journal the JAX package dumps
loads in the port and back.
"""

import torch_threads  # noqa: F401  (one torch thread per worker)

import importlib
import json

import pytest
import torch_obs_pins as O

from kueue_oss_tpu import obs as jax_obs
from kueue_oss_tpu_torch import obs as port_obs

J, T = "kueue_oss_tpu", "kueue_oss_tpu_torch"
jax_replay = importlib.import_module("kueue_oss_tpu.sim.replay")
port_replay = importlib.import_module("kueue_oss_tpu_torch.sim.replay")
CASES = sorted(O.CASES)


@pytest.mark.parametrize("case", CASES)
def test_journal_matches_jax(case):
    want, got = O.capture(case, J), O.capture(case, T)
    assert got["journal_full"] == want["journal_full"]
    assert got["journal"] == want["journal"]
    assert len(want["journal"]) > 0


@pytest.mark.parametrize("case", CASES)
def test_explain_and_decisions_match_jax(case):
    want, got = O.capture(case, J), O.capture(case, T)
    assert got["explain"] == want["explain"]
    assert got["decisions"] == want["decisions"]
    assert got["kinds_per_cycle"] == want["kinds_per_cycle"]


def test_the_cases_reach_every_decision_path():
    kinds = {r[0] for c in CASES for r in O.capture(c, T)["journal"]}
    assert {port_obs.ASSIGNED, port_obs.SKIPPED, port_obs.PREEMPTED,
            port_obs.NOMINATED, port_obs.SOLVER_ADMITTED} <= kinds
    paths = {r[4] for c in CASES for r in O.capture(c, T)["journal"]}
    assert paths == {port_obs.HOST, port_obs.SOLVER}
    slugs = {r[5] for r in O.capture("storm_full", T)["journal"]}
    assert {"solver_parked", "InClusterQueue"} & slugs


def test_jax_journal_loads_in_the_port_and_back(tmp_path):
    text = O.capture("lean", J)["jsonl"]
    jax_path = tmp_path / "jax.jsonl"
    jax_path.write_text(text + "{torn line\n")
    events = port_obs.load_jsonl(str(jax_path))
    assert port_obs.load_jsonl.last_skipped == 1
    want = jax_obs.load_jsonl(str(jax_path))
    assert [e.to_dict() for e in events] == [e.to_dict() for e in want]
    # the port's replay reproduces the JAX package's kind counts
    rec = port_replay.replay(events)
    assert (port_replay.kind_counts_per_cycle(rec.events())
            == jax_replay.kind_counts_per_cycle(want))
    assert (port_replay.journal_baseline(events)
            == jax_replay.journal_baseline(want))
    # and a port dump loads back in the JAX package unchanged
    port_path = tmp_path / "port.jsonl"
    assert rec.dump_jsonl(str(port_path)) == len(events)
    back = jax_obs.load_jsonl(str(port_path))
    assert ([(e.kind, e.workload, e.cycle, e.reason_slug, e.breaker)
             for e in back]
            == [(e.kind, e.workload, e.cycle, e.reason_slug, e.breaker)
                for e in want])
    assert [json.loads(x) for x in port_path.read_text().splitlines()][
        0]["workload"] == want[0].workload


def test_recorder_bounds_and_restore_match_jax():
    def drive(mod):
        rec = mod.FlightRecorder(max_events=6, per_workload=2,
                                 max_workloads=3, clock=lambda: 5.0)
        for i in range(10):
            rec.record(mod.SKIPPED, f"ns/w{i % 4}", cycle=i // 3,
                       cluster_queue="cq", reason_slug="no_fit",
                       breaker="closed")
        rec.record(mod.SOLVER_FALLBACK, mod.CYCLE_SCOPE, cycle=9,
                   path=mod.SOLVER, reason_slug="breaker_open",
                   breaker="open")
        out = {"events": [e.to_dict() for e in rec.events()],
               "explain": {k: [e.to_dict() for e in rec.explain(k)]
                           for k in ("ns/w0", "ns/w1", "ns/w3")},
               "decisions": rec.decisions(last_cycles=2)}
        rec.restore(rec.events()[:3])
        rec.record(mod.ASSIGNED, "ns/w9", cycle=11, breaker="closed")
        out["restored"] = [e.to_dict() for e in rec.events()]
        return out

    assert drive(port_obs) == drive(jax_obs)


def test_configure_applies_the_observability_config(tmp_path):
    from kueue_oss_tpu.config import configuration as jax_cfg
    from kueue_oss_tpu_torch.config import configuration as port_cfg

    doc = {"observability": {
        "recorderEnabled": False, "ledgerMaxCycles": 7,
        "exemplars": False,
        "slo": {"queueWaitTarget": 0.9, "fastWindowSeconds": 60.0,
                "alertWebhookUrl": "http://127.0.0.1:9/hook"},
        "devtel": {"enabled": True, "captureEnabled": True,
                   "captureMaxSeconds": 2.0}}}

    def state(pkg, cfg_mod):
        obs, metrics, devtel, _ = O.modules(pkg)
        O.reset(pkg)
        try:
            cfg = cfg_mod.load(doc)
            obs.configure(cfg.observability, capture_dir=str(tmp_path))
            return {"recorder": obs.recorder.enabled,
                    "ledger": obs.cycle_ledger.max_cycles,
                    "exemplars": metrics.exemplars_enabled,
                    "slo": obs.slo_engine.objective(),
                    "sink": obs.slo_engine._config_sink.url,
                    "devtel": devtel.collector.status()}
        finally:
            obs.configure(cfg_mod.ObservabilityConfig())
            O.reset(pkg)

    assert state(T, port_cfg) == state(J, jax_cfg)

"""The port's cycle ledger (``kueue_oss_tpu_torch/obs/ledger.py``) and
the rows the scheduler, the engine and the streaming admitter record in
it, against the JAX package on the CPU.

Tolerance 0 on every row's kind, cycle, breaker, counts, skip slugs,
solver arm, frame kind / bytes / reason, session stats, phase names and
resident-state deltas (bytes included: these runs ship no delta whose
row index dtype differs, see tests/torch_obs_pins.py), for a lean flood
with finishes, the TAS store through ``Scheduler(solver="auto")`` and
the preemption storm through host cycles and the FULL drain. A solver
row carries the engine's real phases (export, its columnar walk and
scatter, encode, device_put, solve, apply): not the two-phase set the
JAX package's own ``test_health.py`` asserts (ROADMAP Queue C).
"""

import torch_threads  # noqa: F401  (one torch thread per worker)

import pytest
import torch_obs_pins as O

from kueue_oss_tpu import obs as jax_obs
from kueue_oss_tpu_torch import obs as port_obs

J, T = "kueue_oss_tpu", "kueue_oss_tpu_torch"
CASES = ["lean", "storm_full", "storm_host", "tas"]


@pytest.mark.parametrize("case", CASES)
def test_ledger_rows_match_jax(case):
    want, got = O.capture(case, J), O.capture(case, T)
    assert got["ledger"] == want["ledger"]
    assert want["ledger"]


def test_solver_rows_carry_the_engine_phases():
    rows = [r for c in CASES for r in O.capture(c, T)["ledger"]
            if r["kind"] == port_obs.SOLVER_DRAIN]
    assert rows
    local = {"export", "encode", "device_put", "solve", "apply"}
    for r in rows:
        assert local <= set(r["phases"]), r
        assert set(r["phases"]) <= local | {"export_walk",
                                            "export_scatter"}
        assert r["solverArm"] == "single"
        assert r["frameKind"] in ("sync", "delta")
    lean = [r for r in O.capture("lean", T)["ledger"]
            if r["kind"] == port_obs.SOLVER_DRAIN]
    assert lean[0]["frameReason"] == "first_sync"
    host = [r for r in O.capture("storm_host", T)["ledger"]]
    assert {r["kind"] for r in host} == {port_obs.HOST_CYCLE}
    assert all(r["phases"] == ["entries", "flush", "nominate", "snapshot"]
               for r in host)


def test_ledger_ring_dump_and_restore_match_jax(tmp_path):
    def drive(mod, path):
        led = mod.CycleLedger(max_cycles=4, clock=lambda: 3.0)
        for c in range(6):
            led.record(c, mod.HOST_CYCLE, heads=c, admitted=c // 2,
                       skip_slugs={"no_fit": c}, phases={"snapshot": 0.1})
        led.record(6, mod.SOLVER_DRAIN, solver_arm="single", rounds=3,
                   frame_kind="sync", frame_bytes=128,
                   frame_reason="first_sync", device={"full_upload_bytes":
                                                      64})
        led.resize(3)
        n = led.dump_jsonl(str(path))
        with open(path, "a") as fh:
            fh.write("not json\n")
        back = mod.load_ledger_jsonl(str(path))
        led.restore(back[:2])
        led.record(9, mod.STREAM_DRAIN, admitted=1, solver_arm="stream")
        return {"n": n, "skipped": mod.load_ledger_jsonl.last_skipped,
                "rows": [r.to_dict() for r in led.rows()],
                "for_cycle": [r.to_dict() for r in led.rows_for_cycle(6)],
                "last": led.last_row(mod.HOST_CYCLE).to_dict()}

    assert (drive(port_obs, tmp_path / "p.jsonl")
            == drive(jax_obs, tmp_path / "j.jsonl"))


def test_ledger_off_records_nothing():
    from kueue_oss_tpu_torch.debugger.profiling import Tracer

    O.reset(T)
    port_obs.cycle_ledger.enabled = False
    port_obs.recorder.enabled = False
    try:
        import torch_scheduler_pins as P

        O.run_lean(P.port_package("cpu"), tracer=Tracer(),
                   prof=__import__("kueue_oss_tpu_torch.debugger.profiling",
                                   fromlist=["x"]))
        assert port_obs.cycle_ledger.rows() == []
        assert port_obs.recorder.events() == []
    finally:
        O.reset(T)

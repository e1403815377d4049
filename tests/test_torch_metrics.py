"""The port's metrics registry (``kueue_oss_tpu_torch/metrics/``)
against the JAX package's on the CPU.

Tolerance 0: the same series (name, type, help, labels, buckets), the
same exposition text (classic and OpenMetrics, exemplars included) for
the same observations, and the same deterministic samples of
``render()`` (counters, gauges, histogram counts; no wall-clock sample)
after a lean flood with finishes, the TAS store and the preemption
storm through host cycles. The port's plain counters that code reads
(the breaker's ``state`` / ``trips``, the farm's ledgers) equal their
series.
"""

import torch_threads  # noqa: F401  (one torch thread per worker)

import pytest
import torch_obs_pins as O

from kueue_oss_tpu import metrics as jax_metrics
from kueue_oss_tpu_torch import metrics as port_metrics

J, T = "kueue_oss_tpu", "kueue_oss_tpu_torch"


def _series(mod):
    out = []
    for s in mod.registry._series_snapshot():
        out.append((s.name, s.kind, s.help, tuple(s.labels),
                    tuple(getattr(s, "buckets", ()))))
    return out


def test_registry_has_every_jax_series():
    assert _series(port_metrics) == _series(jax_metrics)


@pytest.mark.parametrize("case", ["lean", "storm_host", "tas"])
def test_deterministic_render_matches_jax(case):
    want, got = O.capture(case, J), O.capture(case, T)
    assert got["render"] == want["render"]
    assert any(line.startswith("kueue_admitted_workloads_total")
               for line in got["render"])


def test_exposition_formats_match_jax():
    def drive(mod):
        mod.reset_all()
        try:
            mod.admitted_workload("cq-a", 3.5, lq="lq", namespace="ns",
                                  exemplar={"cycle": 4, "workload": "ns/w"})
            mod.quota_reserved_workload("cq-\"b\"\n", 700.0)
            mod.evicted_workloads_total.inc("cq-a", "Preempted", by=2)
            mod.pending_workloads.replace_prefix(
                ("cq-a",), {("active",): 3.0})
            mod.pending_workloads.replace_prefix(("cq-a",), {})
            mod.solver_farm_grant_wait_seconds.observe(
                "t", value=0.003, exemplar={"cycle": 1}, exemplar_ts=2.0)
            mod.exemplars_enabled = False
            mod.admission_wait_time_seconds.observe(
                "cq-a", value=1.0, exemplar={"dropped": 1})
            return (mod.registry.render(),
                    mod.registry.render(openmetrics=True),
                    mod.admission_wait_time_seconds.exemplars("cq-a"))
        finally:
            mod.exemplars_enabled = True
            mod.reset_all()

    assert drive(port_metrics) == drive(jax_metrics)


def test_breaker_state_and_trips_equal_their_series():
    from kueue_oss_tpu_torch.solver.resilience import SolverHealth

    port_metrics.reset_all()
    t = [0.0]
    h = SolverHealth(failure_threshold=2, cooldown_s=5.0,
                     clock=lambda: t[0])
    gauge = port_metrics.solver_breaker_state
    seen = []
    for step in ("f", "f", "wait", "probe", "f", "wait", "probe", "ok"):
        if step == "f":
            h.record_failure()
        elif step == "wait":
            t[0] += 6.0
        elif step == "probe":
            assert h.allow()
        else:
            h.record_success()
        seen.append((h.state, gauge.value()))
        assert (port_metrics.solver_breaker_trips_total.value()
                == h.trips)
    codes = {"closed": 0.0, "half-open": 1.0, "open": 2.0}
    assert all(codes[s] == v for s, v in seen[1:])
    assert h.trips == 2
    port_metrics.reset_all()


def test_farm_ledgers_equal_their_series():
    from kueue_oss_tpu_torch.federation.farm import FarmScheduler

    port_metrics.reset_all()
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    farm = FarmScheduler(weights={"a": 2.0, "b": 1.0}, max_queued=1,
                         clock=clock)
    for tenant in ("a", "b", "a", "b", "a"):
        farm.run(tenant, lambda: ({"ok": True}, b""))
    farm.force_throttle("b")
    farm.run("b", lambda: ({"ok": True}, b""))
    for tenant in ("a", "b"):
        assert (port_metrics.solver_farm_requests_total.value(tenant)
                == farm.served.get(tenant, 0))
        assert (port_metrics.solver_farm_wall_seconds_total.value(tenant)
                == farm.wall_by_tenant.get(tenant, 0.0))
        assert (port_metrics.solver_farm_throttled_total.value(tenant)
                == farm.throttled.get(tenant, 0))
        assert (port_metrics.solver_farm_grant_wait_seconds.count(tenant)
                == farm.served.get(tenant, 0))
    assert port_metrics.solver_farm_tenants.value() == 2
    assert farm.throttled == {"b": 1}
    port_metrics.reset_all()

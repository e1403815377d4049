"""The port's solver farm (kueue_oss_tpu_torch/federation/farm.py)
against the JAX package's, grant for grant.

Both ``FarmScheduler``s run in lockstep under one driven clock: the same
tenants, tickets, walls and knob changes go to each, and after every
grant the winner, every tenant's deficit and the ledgers (``served``,
``wall_by_tenant``, ``throttled``) must be equal. The deficits are
Python floats computed in the same order, so the tolerance is exact
equality throughout. No test compiles anything in JAX.
"""

import pytest

from kueue_oss_tpu import metrics as jax_metrics
from kueue_oss_tpu.config import load as jax_load
from kueue_oss_tpu.federation import farm as jax_farm
from kueue_oss_tpu_torch import config as port_config
from kueue_oss_tpu_torch.federation import farm as port_farm

FARMS = (jax_farm, port_farm)


@pytest.fixture(autouse=True)
def _reset_jax_metrics():
    jax_metrics.reset_all()
    yield
    jax_metrics.reset_all()


class Clock:
    """The driven clock both farms read."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _pair(**kw):
    clock = Clock()
    return clock, [m.FarmScheduler(clock=clock, **kw) for m in FARMS]


def _state(fs) -> tuple:
    with fs._lock:
        state = (dict(fs._deficit), list(fs._ring), fs._cursor,
                 {t: len(q) for t, q in fs._queues.items()},
                 dict(fs.served), dict(fs.wall_by_tenant),
                 dict(fs.throttled))
    return state + (fs.stats(),)


def _grant(mod, fs, tenants, pending, depth):
    """Keep every tenant in ``tenants`` backlogged ``depth`` deep, run
    one grant opportunity and return the winner (None when nothing was
    granted)."""
    with fs._lock:
        for t in tenants:
            fs._register_locked(t)
            while len(fs._queues[t]) < depth:
                tk = mod._Ticket()
                fs._queues[t].append(tk)
                pending[t].append(tk)
        fs._grant_next_locked()
    for t in fs._ring:
        for tk in pending.get(t, []):
            if tk.granted.is_set():
                pending[t].remove(tk)
                return t
    return None


def _lockstep(farms, total, wall_for, tenants_at=None, depth=2,
              between=None):
    """Pump ``total`` grants through both farms' single slot; per step
    the backlogged tenants are ``tenants_at(step)`` (all of them by
    default), the winner is charged ``wall_for(tenant, step)`` and
    ``between(step, farm)`` may change a knob. Returns the winners."""
    pendings = [{} for _ in farms]
    winners = []
    for step in range(total):
        got = []
        for mod, fs, pending in zip(FARMS, farms, pendings):
            tenants = (tenants_at(step) if tenants_at is not None
                       else sorted(fs.weights) or ["a", "b"])
            for t in tenants:
                pending.setdefault(t, [])
            w = _grant(mod, fs, tenants, pending, depth)
            assert w is not None, "a backlogged farm must always grant"
            fs._complete(w, wall_for(w, step))
            got.append(w)
        assert got[0] == got[1], f"step {step}: grants {got}"
        assert _state(farms[0]) == _state(farms[1]), f"step {step}"
        winners.append(got[0])
        if between is not None:
            for fs in farms:
                between(step, fs)
        assert _state(farms[0]) == _state(farms[1]), f"step {step} knob"
    return winners


@pytest.mark.parametrize("weights,costs", [
    ({"a": 3.0, "b": 1.0}, {"a": 0.01, "b": 0.01}),
    ({"a": 1.0, "b": 1.0}, {"a": 0.005, "b": 0.001}),
    ({"a": 2.0, "b": 2.0, "c": 1.0, "d": 1.0},
     {"a": 0.003, "b": 0.0011, "c": 0.007, "d": 0.0005}),
], ids=["weighted", "uneven_costs", "four_tenants"])
def test_grant_sequence_and_deficits_match_jax(weights, costs):
    _, farms = _pair(weights=weights, quantum_s=0.002, max_queued=64)
    winners = _lockstep(farms, 240, lambda t, _s: costs[t])
    served = farms[1].served
    assert set(winners) == set(weights) and sum(served.values()) == 240


def test_idle_forfeit_and_credit_cap_match_jax():
    """A debtor forces accrual rounds on its neighbour (capped credit);
    a tenant that drops out of the backlog forfeits its credit."""
    _, farms = _pair(quantum_s=0.01, max_credit_quanta=2.0, max_queued=64)

    def tenants(step):
        return ["debtor", "saver"] + (["idler"] if step % 7 < 3 else [])

    def wall(t, step):
        return 0.08 if t == "debtor" else 0.001 * (1 + step % 3)

    _lockstep(farms, 90, wall, tenants_at=tenants)
    for fs in farms:
        cap = fs.quantum_s * fs.weight("saver") * fs.max_credit_quanta
        assert fs._deficit["saver"] <= cap


def test_set_weights_and_reload_config_between_grants_match_jax():
    _, farms = _pair(weights={"a": 1.0, "b": 1.0}, quantum_s=0.002,
                     max_queued=64)
    cfgs = {m: m_load({"federation": {
        "tenantWeights": {"a": 0.5, "b": 3.0}, "defaultWeight": 2.0,
        "quantum": 0.003, "maxQueued": 5, "maxCreditQuanta": 1.5}})
        for m, m_load in ((jax_farm, jax_load),
                          (port_farm, port_config.load))}

    def between(step, fs):
        mod = jax_farm if isinstance(fs, jax_farm.FarmScheduler) else \
            port_farm
        if step == 40:
            assert fs.set_weights({"a": 4.0}, default_weight=0.25) == {
                "a": 4.0}
        elif step == 80:
            assert fs.reload_config(cfgs[mod].federation) == {
                "a": 0.5, "b": 3.0}

    _lockstep(farms, 120, lambda t, s: 0.001 * (1 + (s * 7) % 5),
              tenants_at=lambda s: ["a", "b", "c"], between=between)
    assert [f.max_queued for f in farms] == [5, 5]


@pytest.mark.parametrize("call", [
    lambda fs: fs.set_weights({"a": 0.0}),
    lambda fs: fs.set_weights({"a": -1.0}),
    lambda fs: fs.set_weights({"a": float("inf")}),
    lambda fs: fs.set_weights({"a": float("nan")}),
    lambda fs: fs.set_weights(default_weight=0.0),
    lambda fs: fs.set_weights(default_weight=float("inf")),
], ids=["zero", "negative", "inf", "nan", "default_zero", "default_inf"])
def test_rejected_weights_raise_the_same_error(call):
    _, farms = _pair(weights={"a": 2.0})
    errors = []
    for fs in farms:
        with pytest.raises(ValueError) as e:
            call(fs)
        errors.append(str(e.value))
        assert fs.weights == {"a": 2.0} and fs.default_weight == 1.0
    assert errors[0] == errors[1]


def test_rejected_reload_config_keeps_weights_but_takes_knobs():
    """``reload_config`` sets the quantum, max_queued and the cap before
    it validates the weights (the JAX order): a rejected document
    leaves the weights and takes the rest, in both packages."""
    doc = {"federation": {"tenantWeights": {"a": 0.0}, "quantum": 0.5,
                          "maxQueued": 3}}
    _, farms = _pair(weights={"a": 2.0})
    for fs, load in zip(farms, (jax_load, port_config.load)):
        with pytest.raises(ValueError):
            fs.reload_config(load(doc).federation)
    assert _state(farms[0]) == _state(farms[1])
    assert [(f.weights, f.quantum_s, f.max_queued) for f in farms] == [
        ({"a": 2.0}, 0.5, 3)] * 2


def test_run_ledgers_and_grant_wait_match_jax():
    """``run`` on one thread: an idle slot grants at once; the body's
    driven wall is charged; the grant wait is the clock's."""
    clock, farms = _pair(weights={"a": 2.0, "b": 1.0}, quantum_s=0.002)
    waits = {0: [], 1: []}
    for step in range(30):
        tenant = "ab"[step % 3 == 2]
        for i, (mod, fs) in enumerate(zip(FARMS, farms)):
            start = clock.t

            def body():
                clock.t += 0.001 * (1 + step % 4)
                return {"ok": True, "step": step}, b"x"

            assert fs.run(tenant, body) == ({"ok": True, "step": step},
                                            b"x")
            waits[i].append(mod.last_grant_wait_s())
            clock.t = start
        assert _state(farms[0]) == _state(farms[1])
    assert waits[0] == waits[1]
    assert farms[1].served == {"a": 20, "b": 10}


def test_body_exception_releases_the_slot_in_both():
    clock, farms = _pair()
    for fs in farms:
        def boom():
            clock.t += 0.004
            raise RuntimeError("solve failed")

        with pytest.raises(RuntimeError):
            fs.run("t", boom)
        assert not fs._busy
        clock.t = 0.0
    assert _state(farms[0]) == _state(farms[1])


def test_backpressure_on_queue_overflow_matches_jax():
    _, farms = _pair(max_queued=2)
    answers = []
    for mod, fs in zip(FARMS, farms):
        fs._busy = True  # wedge the slot so nothing drains
        with fs._lock:
            fs._register_locked("t")
            fs._queues["t"].extend([mod._Ticket(), mod._Ticket()])
        answers.append(fs.run("t", lambda: ({"ok": True}, b"")))
    assert answers[0] == answers[1]
    header, blob = answers[1]
    assert header["ok"] is False and "backpressure" in header["error"]
    assert blob == b"" and farms[1].throttled == {"t": 1}
    assert _state(farms[0]) == _state(farms[1])


def test_backpressure_on_grant_timeout_matches_jax():
    _, farms = _pair(grant_timeout_s=0.01)
    answers = []
    for fs in farms:
        fs._busy = True  # the slot never frees: the grant wait times out
        answers.append(fs.run("t", lambda: ({"ok": True}, b"")))
        assert not fs._queues["t"], "the starved ticket is withdrawn"
    assert answers[0] == answers[1]
    assert "grant wait timed out" in answers[1][0]["error"]
    assert _state(farms[0]) == _state(farms[1])


def test_force_throttle_matches_jax():
    clock, farms = _pair()
    for fs in farms:
        fs.force_throttle("t", times=2)
        fs.force_throttle("u")
    outs = [[fs.run(t, lambda: ({"ok": True}, b"")) for t in
             ("t", "u", "t", "t", "u")] for fs in farms]
    assert outs[0] == outs[1]
    assert [h["ok"] for h, _ in outs[1]] == [False, False, False, True,
                                              True]
    assert "injected farm partition" in outs[1][0][0]["error"]
    assert farms[1].throttled == {"t": 2, "u": 1}
    assert farms[1].throttle_fault == {"t": 0, "u": 0}
    assert _state(farms[0]) == _state(farms[1])


def test_from_config_matches_jax():
    doc = {"federation": {"tenantWeights": {"a": 2.0, "b": 0.5},
                          "defaultWeight": 0.75, "quantum": 0.004,
                          "maxQueued": 3, "maxCreditQuanta": 2.5}}
    clock = Clock()
    got = [m.FarmScheduler.from_config(load(doc).federation, clock=clock)
           for m, load in ((jax_farm, jax_load),
                           (port_farm, port_config.load))]
    knobs = [(f.weights, f.default_weight, f.quantum_s, f.max_queued,
              f.max_credit_quanta, f.grant_timeout_s) for f in got]
    assert knobs[0] == knobs[1] == ({"a": 2.0, "b": 0.5}, 0.75, 0.004, 3,
                                    2.5, 600.0)
    _lockstep(got, 60, lambda t, s: 0.001 * (1 + s % 3),
              tenants_at=lambda s: ["a", "b", "c"])


def test_attach_farm_wires_the_server():
    class Server:
        farm = None

    for mod in FARMS:
        srv = Server()
        fs = mod.attach_farm(srv, weights={"a": 3.0}, quantum_s=0.01)
        assert srv.farm is fs and fs.weights == {"a": 3.0}
        own = mod.FarmScheduler()
        assert mod.attach_farm(srv, own) is own and srv.farm is own

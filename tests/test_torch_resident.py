"""The port's resident device state (``DeviceResidentProblem`` in
kueue_oss_tpu_torch/solver/delta.py) on the CPU, lean and FULL,
through the engine's drains under a finish-and-arrive churn cycle.

After every drain the resident tensors must equal a fresh upload of the
session's slotted problem (``torch.equal``), share no memory with any
array of that problem, and keep their storage (``data_ptr``) across
delta epochs and across a full sync whose shapes all match. The drain's
solve must leave every resident tensor unchanged. A fault inside a
delta application heals through a full upload counted in
``apply_faults``; a row update of another dtype, or with a repeated
row, raises instead of casting or racing.
"""

import numpy as np
import pytest
import torch

from kueue_oss_tpu_torch.api import types
from kueue_oss_tpu_torch.core.eviction import finish_workload
from kueue_oss_tpu_torch.core.queue_manager import QueueManager
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.scenarios import StormChurn, baseline_preempt_store
from kueue_oss_tpu_torch.solver import engine as engine_mod
from kueue_oss_tpu_torch.solver.delta import (
    DeviceResidentProblem,
    ProblemDelta,
    SessionFrame,
)
from kueue_oss_tpu_torch.solver.engine import SolverEngine


def _lean_store():
    store = Store()
    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    for i in range(4):
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{i}", resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[types.FlavorQuotas(name="f", resources=[
                    types.ResourceQuota(name="cpu", nominal=6)])])]))
        store.upsert_local_queue(types.LocalQueue(name=f"lq{i}",
                                                  cluster_queue=f"cq{i}"))
    for i in range(40):
        store.add_workload(types.Workload(
            name=f"w{i}", queue_name=f"lq{i % 4}", uid=i + 1,
            priority=i % 3, creation_time=float(i),
            podsets=[types.PodSet(name="main", count=1,
                                  requests={"cpu": 1 + i % 2})]))
    return store


def _full_store():
    store, wave1, wave2 = baseline_preempt_store(
        types, Store, n_cohorts=1, cqs_per_cohort=2, scale=0.06)
    for wl in wave1 + wave2:
        store.add_workload(wl)
    return store


def _engine(kind):
    store = _lean_store() if kind == "lean" else _full_store()
    queues = QueueManager(store)
    engine = SolverEngine(store, queues, device="cpu")
    engine.pad_to = 64
    return store, queues, engine


def _check_resident(engine, kind):
    """Resident tensors == a fresh upload of the slotted problem, and
    none of them shares memory with the problem's arrays."""
    dev = engine._device_states[kind]
    slotted = engine._delta_sessions[kind]._last_slotted
    fresh = dev._host(slotted, kind == "full")
    arrays = [v for v in vars(slotted).values()
              if isinstance(v, np.ndarray)] + [np.asarray(a) for a in fresh]
    for name, t, h in zip(dev.tensors._fields, dev.tensors, fresh):
        assert t.device.type == "cpu"
        assert torch.equal(t, torch.from_numpy(np.asarray(h))), name
        view = t.numpy()
        assert not any(np.shares_memory(view, a) for a in arrays), name
    return [t.data_ptr() for t in dev.tensors]


def _checked_solver(real):
    """The drain's solve, asserting that it leaves its inputs as it
    found them."""
    def solve(tensors, **kw):
        before = [t.clone() for t in tensors]
        out = real(tensors, **kw)
        for name, b, t in zip(tensors._fields, before, tensors):
            assert torch.equal(b, t), f"the solve wrote into {name}"
        return out
    return solve


@pytest.mark.parametrize("kind", ["lean", "full"])
def test_resident_state_equals_fresh_upload_under_churn(kind, monkeypatch):
    monkeypatch.setattr(engine_mod, "solve_backlog", _checked_solver(
        engine_mod.solve_backlog))
    monkeypatch.setattr(engine_mod, "solve_backlog_full", _checked_solver(
        engine_mod.solve_backlog_full))
    store, queues, engine = _engine(kind)
    first = engine.drain(now=1.0)
    assert first.frame.full_reason == "first_sync"
    assert first.device == {"full_uploads": 1, "delta_updates": 0,
                            "full_upload_bytes": first.device[
                                "full_upload_bytes"],
                            "donated_update_bytes": 0,
                            "donated_full_syncs": 0, "apply_faults": 0}
    ptrs = _check_resident(engine, kind)
    churn = StormChurn(types, store, 3)
    deltas = 0
    for c in range(2, 7):
        churn.cycle(c, lambda k, now: finish_workload(store, queues, k, now))
        result = engine.drain(now=float(c))
        now_ptrs = _check_resident(engine, kind)
        if result.frame.delta is not None:
            deltas += 1
            assert now_ptrs == ptrs, "a delta epoch writes in place"
            assert result.device["delta_updates"] == 1
            assert result.device["full_uploads"] == 0
            assert 0 < result.device["donated_update_bytes"] < (
                engine._device_states[kind].resident_bytes())
        elif result.device["donated_full_syncs"]:
            assert now_ptrs == ptrs, "a same-shape sync writes in place"
        else:
            # a sync that changed a shape (here: the class space grew
            # for the arrivals' new scheduling shape) allocates afresh
            assert result.device["full_uploads"] == 1
            ptrs = now_ptrs
    assert deltas >= 2, "the churn must reach delta epochs"

    # a full sync whose shapes all match rewrites the buffers in place
    dev = engine._device_states[kind]
    sess = engine._delta_sessions[kind]
    syncs = dev.donated_full_syncs
    dev.update(sess._last_slotted, SessionFrame(
        epoch=sess.epoch, checksum=0, delta=None, full_reason="forced"),
        kind == "full")
    assert dev.donated_full_syncs == syncs + 1
    assert _check_resident(engine, kind) == ptrs
    assert dev.apply_faults == 0


def test_apply_fault_heals_by_a_counted_full_upload(monkeypatch):
    store, queues, engine = _engine("full")
    engine.drain(now=1.0)
    churn = StormChurn(types, store, 3)
    for c in (2, 3):
        churn.cycle(c, lambda k, now: finish_workload(store, queues, k, now))
        engine.drain(now=float(c))
    dev = engine._device_states["full"]
    deltas = dev.delta_updates
    assert deltas >= 1

    def broken(self, buf, idx, vals):
        raise RuntimeError("injected fault")
    monkeypatch.setattr(DeviceResidentProblem, "_write_rows", broken)
    churn.cycle(4, lambda k, now: finish_workload(store, queues, k, now))
    result = engine.drain(now=4.0)
    assert result.frame.delta is not None, "the session sent a delta"
    assert result.device["apply_faults"] == 1
    assert result.device["full_uploads"] == 1
    assert dev.apply_faults == 1 and dev.delta_updates == deltas
    monkeypatch.undo()
    _check_resident(engine, "full")


def test_row_updates_need_the_exact_dtype_and_unique_rows():
    store, queues, engine = _engine("full")
    engine.drain(now=1.0)
    dev = engine._device_states["full"]
    slotted = engine._delta_sessions["full"]._last_slotted
    buf = dev.tensors.wl_prio
    with pytest.raises(TypeError, match="dtype"):
        dev._write_rows(buf, np.asarray([0, 1], np.int32),
                        np.asarray([5, 6], np.int64))
    with pytest.raises(ValueError, match="unique rows"):
        dev._write_rows(buf, np.asarray([2, 2], np.int32),
                        np.asarray([5, 6], np.int32))
    with pytest.raises(TypeError, match="replacement"):
        dev._write_all(dev.tensors.usage0,
                       np.asarray(slotted.usage0, dtype=np.int64))
    dev._write_rows(buf, np.asarray([0, 3], np.int32),
                    np.asarray([5, 6], np.int32))
    assert buf[[0, 3]].tolist() == [5, 6]

    # through update: the bad delta heals (counted) instead of casting
    bad = ProblemDelta(epoch=dev.epoch + 1, base_epoch=dev.epoch,
                       checksum=0, row_updates={"wl_prio": (
                           np.asarray([0], np.int32),
                           np.asarray([7], np.int64))})
    dev.update(slotted, SessionFrame(epoch=dev.epoch + 1, checksum=0,
                                     delta=bad), True)
    assert dev.apply_faults == 1
    _check_resident(engine, "full")

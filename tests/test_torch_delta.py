"""The port's delta sessions (kueue_oss_tpu_torch/solver/delta.py, host
half) against the JAX package's, tolerance 0.

- ``StableRanker``: order and identity across appends and midpoint
  inserts, the renumber on gap exhaustion, the same ranks as JAX's.
- Random event sequences (create / drain / finish / evict / quota edit;
  the seeds of tests/test_solver_delta.py) run on identical stores of
  both packages. After every batch each package exports its FULL
  problem through its engine's ``ExportCache``, pads it, and advances a
  ``HostDeltaSession`` (FULL kind, ``wl_rank`` neutral) with the
  export's columnar hint. The port's slotted problem must equal JAX's
  field by field (``wl_keys`` included), and so must the frame: the
  checksum, ``full_reason``, and the delta's rows, values,
  replacements and meta. Interleave widths 1 and 2, and one sequence
  with the SchedulerTimestampPreemptionBuffer gate on in both packages
  (``wl_ts_buf`` from the buffered ranks).
- The port's ``apply_delta`` replay of each frame's delta (copied, so
  the receiver shares no array with the session) must reproduce a
  fresh sync bit for bit.
- The ranker prune: an oversized registry resets with a full sync
  (``ranker_prune``), as in JAX.
"""


import torch_threads  # noqa: F401  (one torch thread per worker)
import dataclasses
import random

import numpy as np
import pytest

from kueue_oss_tpu import features as jax_features
from kueue_oss_tpu.api import types as jax_types
from kueue_oss_tpu.core.queue_manager import QueueManager as JaxQueues
from kueue_oss_tpu.core.store import Store as JaxStore
from kueue_oss_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kueue_oss_tpu.solver import delta as jax_delta
from kueue_oss_tpu.solver.engine import SolverEngine as JaxEngine
from kueue_oss_tpu.solver.tensors import export_problem as jax_export
from kueue_oss_tpu.solver.tensors import pad_workloads as jax_pad
from kueue_oss_tpu_torch import features as port_features
from kueue_oss_tpu_torch.api import types as port_types
from kueue_oss_tpu_torch.core.eviction import evict_workload, finish_workload
from kueue_oss_tpu_torch.core.queue_manager import QueueManager as PortQueues
from kueue_oss_tpu_torch.core.store import Store as PortStore
from kueue_oss_tpu_torch.solver import delta as port_delta
from kueue_oss_tpu_torch.solver.engine import SolverEngine as PortEngine
from kueue_oss_tpu_torch.solver.tensors import export_problem as port_export
from kueue_oss_tpu_torch.solver.tensors import pad_workloads as port_pad


def _store(types, store_cls, n_cqs=4, quota=6):
    """tests/test_solver_delta.py's store for either package."""
    store = store_cls()
    store.upsert_resource_flavor(types.ResourceFlavor(name="f"))
    for i in range(n_cqs):
        store.upsert_cluster_queue(types.ClusterQueue(
            name=f"cq{i}",
            preemption=types.PreemptionPolicy(
                within_cluster_queue=(
                    types.PreemptionPolicyValue.LOWER_PRIORITY)),
            resource_groups=[types.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[types.FlavorQuotas(name="f", resources=[
                    types.ResourceQuota(name="cpu", nominal=quota)])])]))
        store.upsert_local_queue(types.LocalQueue(
            name=f"lq{i}", cluster_queue=f"cq{i}"))
    return store


class _Side:
    """One package's store, queues, engine and event verbs."""

    def __init__(self, port: bool):
        self.port = port
        self.types = port_types if port else jax_types
        self.store = _store(self.types, PortStore if port else JaxStore)
        if port:
            self.queues = PortQueues(self.store)
            self.engine = PortEngine(self.store, self.queues, device="cpu")
        else:
            self.queues = JaxQueues(self.store)
            self.sched = JaxScheduler(self.store, self.queues)
            self.engine = JaxEngine(self.store, self.queues,
                                    scheduler=self.sched, mesh_mode="off")
        # the relaxed arm routes by wall clock: pinned off on both sides
        self.engine.relax_enabled = False

    def submit(self, i, prio):
        self.store.add_workload(self.types.Workload(
            name=f"w{i}", queue_name=f"lq{i % 4}", uid=i + 1, priority=prio,
            creation_time=float(i),
            podsets=[self.types.PodSet(name="main", count=1,
                                       requests={"cpu": 1})]))

    def finish(self, key, now):
        if self.port:
            finish_workload(self.store, self.queues, key, now)
        else:
            self.sched.finish_workload(key, now=now)

    def evict(self, key, now):
        if self.port:
            evict_workload(self.store, self.queues, key, reason="Preempted",
                           message="chaos", now=now)
        else:
            self.sched.evict_workload(key, reason="Preempted",
                                      message="chaos", now=now)

    def admitted(self):
        return sorted(k for k, w in self.store.workloads.items()
                      if w.is_quota_reserved)

    def export_full(self, now):
        """The FULL export of the backlog as the drain builds it."""
        pending = self.engine.pending_backlog()
        parked = {name: list(q.inadmissible.values())
                  for name, q in self.queues.queues.items()
                  if q.inadmissible}
        export = port_export if self.port else jax_export
        problem = export(self.store, pending, include_admitted=True,
                         parked=parked, now=now,
                         cache=self.engine.export_cache)
        return problem if problem.n_workloads else None


def _assert_problems_equal(got, want, label):
    for name in want.__dataclass_fields__:
        w, g = getattr(want, name), getattr(got, name)
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), (label, name)
            assert g.dtype == w.dtype and g.shape == w.shape, (label, name)
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")
        else:
            assert g == w, (label, name)


def _assert_frames_equal(got, want, label):
    assert (got.epoch, got.checksum, got.full_reason) == (
        want.epoch, want.checksum, want.full_reason), label
    assert (got.delta is None) == (want.delta is None), label
    if want.delta is None:
        return
    g, w = got.delta, want.delta
    assert (g.epoch, g.base_epoch, g.checksum) == (
        w.epoch, w.base_epoch, w.checksum), label
    assert sorted(g.row_updates) == sorted(w.row_updates), label
    for name, (idx, vals) in w.row_updates.items():
        gi, gv = g.row_updates[name]
        assert gi.dtype == idx.dtype and gv.dtype == vals.dtype, (label, name)
        np.testing.assert_array_equal(gi, idx, err_msg=f"{label} {name}")
        np.testing.assert_array_equal(gv, vals, err_msg=f"{label} {name}")
    assert sorted(g.repl) == sorted(w.repl), label
    for name, arr in w.repl.items():
        assert g.repl[name].dtype == arr.dtype, (label, name)
        np.testing.assert_array_equal(g.repl[name], arr, err_msg=name)
    assert g.meta_delta == w.meta_delta, label
    assert g.payload_bytes() == w.payload_bytes(), label


def test_stable_ranker_order_identity_and_renumber_match_jax():
    for gap, batches in ((8, [[3.0, 1.0, 2.0], [10.0, 2.5], [2.25, 0.5]]),
                         (2, [[0.0, 1.0], [0.1], [0.11], [0.12], [0.13]])):
        p, j = port_delta.StableRanker(gap=gap), jax_delta.StableRanker(
            gap=gap)
        seen, first = [], {}
        for batch in batches:
            vals = np.asarray(batch)
            assert p.update(vals) == j.update(vals)
            seen.extend(batch)
            allv = np.asarray(sorted(set(seen)))
            np.testing.assert_array_equal(p.rank(allv), j.rank(allv))
            assert (np.diff(p.rank(allv)) > 0).all(), "order is strict"
            assert p.max == j.max and p.size == j.size
            if not p.renumbers:
                for v, r in zip(allv, p.rank(allv)):
                    assert first.setdefault(v, int(r)) == int(r), \
                        "existing ranks must not move"
        np.testing.assert_array_equal(
            p.rank_before(np.asarray([0.2, 5.0])),
            j.rank_before(np.asarray([0.2, 5.0])))
    assert p.renumbers == j.renumbers >= 1, "gap 2 exhausts and renumbers"


@pytest.fixture
def buffer_gate(request):
    """SchedulerTimestampPreemptionBuffer on in both packages when the
    case asks for it (the port reads its gate defaults, so the test
    patches the default; the JAX package sets its gate)."""
    name = "SchedulerTimestampPreemptionBuffer"
    on = request.param
    old = jax_features.enabled(name)
    jax_features.set_gates({name: on})
    saved = port_features._DEFAULTS[name]
    port_features._DEFAULTS[name] = on
    yield on
    port_features._DEFAULTS[name] = saved
    jax_features.set_gates({name: old})


@pytest.mark.parametrize("seed,interleave,buffer_gate",
                         [(0, 1, False), (7, 1, False), (23, 1, False),
                          (7, 2, False), (23, 1, True)],
                         indirect=["buffer_gate"])
def test_session_frames_match_jax_over_random_event_sequences(
        seed, interleave, buffer_gate):
    rng = random.Random(seed)
    sides = (_Side(port=False), _Side(port=True))
    sessions = (jax_delta.HostDeltaSession(
        cache=sides[0].engine.export_cache, neutral_fields=("wl_rank",)),
        port_delta.HostDeltaSession(cache=sides[1].engine.export_cache,
                                    neutral_fields=("wl_rank",)))
    for sess in sessions:
        sess.set_interleave(interleave)
    next_uid = [0]

    def submit(n):
        for _ in range(n):
            prio = rng.randrange(3)
            for side in sides:
                side.submit(next_uid[0], prio)
            next_uid[0] += 1

    submit(16)
    receiver = None  # (kwargs, meta) replayed from the port's frames
    kinds = set()
    for step in range(14):
        op = rng.randrange(5)
        now = float(step)
        if op == 0:
            submit(rng.randrange(1, 4))
        elif op == 1:
            want = sides[0].engine.drain(now=now)
            got = sides[1].engine.drain(now=now)
            assert got.admitted_keys == want.admitted_keys
            assert got.evicted_keys == want.evicted_keys
        elif op == 2:
            keys = sides[0].admitted()
            assert sides[1].admitted() == keys
            for k in keys[:rng.randrange(0, 3)]:
                for side in sides:
                    side.finish(k, now)
        elif op == 3:
            keys = sides[0].admitted()
            if keys:
                k = keys[rng.randrange(len(keys))]
                for side in sides:
                    side.evict(k, now)
        else:
            name, nominal = f"cq{rng.randrange(4)}", rng.randrange(4, 9)
            for side in sides:
                cq = side.store.cluster_queues[name]
                cq.resource_groups[0].flavors[0].resources[0].nominal = (
                    nominal)
                side.store.upsert_cluster_queue(cq)

        want_p, got_p = (side.export_full(now) for side in sides)
        assert (got_p is None) == (want_p is None)
        if want_p is None:
            continue
        label = f"seed {seed} step {step}"
        _assert_problems_equal(got_p, want_p, label)
        want_hint = getattr(want_p, "_columnar_hint", None)
        got_hint = getattr(got_p, "_columnar_hint", None)
        assert (got_hint is None) == (want_hint is None)
        want_s, want_f = sessions[0].advance(jax_pad(want_p, 64),
                                             hint=want_hint)
        got_s, got_f = sessions[1].advance(port_pad(got_p, 64),
                                           hint=got_hint)
        _assert_problems_equal(got_s, want_s, label)
        _assert_frames_equal(got_f, want_f, label)
        kinds.add("delta" if got_f.delta is not None else got_f.full_reason)

        kwargs, meta = port_delta.problem_wire_state(got_s)
        assert port_delta.state_checksum(kwargs, meta) == got_f.checksum
        if got_f.delta is None or receiver is None:
            receiver = ({k: (None if v is None else v.copy())
                         for k, v in kwargs.items()}, dict(meta))
        else:
            d = got_f.delta
            copied = dataclasses.replace(
                d, row_updates={k: (i.copy(), v.copy())
                                for k, (i, v) in d.row_updates.items()},
                repl={k: a.copy() for k, a in d.repl.items()})
            port_delta.apply_delta(receiver[0], receiver[1], copied)
        assert port_delta.state_checksum(*receiver) == got_f.checksum
        for name, arr in kwargs.items():
            if arr is None:
                assert receiver[0][name] is None
            else:
                np.testing.assert_array_equal(receiver[0][name], arr,
                                              err_msg=f"{label} {name}")
    assert "delta" in kinds, "the sequence must exercise the delta path"
    assert sessions[1].delta_syncs == sessions[0].delta_syncs
    assert sessions[1].fast_advances == sessions[0].fast_advances


def test_session_prunes_oversized_rankers_like_jax():
    sides = (_Side(port=False), _Side(port=True))
    for i in range(8):
        for side in sides:
            side.submit(i, 0)
    frames = []
    for side, mod, pad in ((sides[0], jax_delta, jax_pad),
                           (sides[1], port_delta, port_pad)):
        session = mod.HostDeltaSession(cache=side.engine.export_cache)
        problem = pad(side.export_full(0.0), 16)
        session.advance(problem)
        session._ts.update(np.arange(5000, dtype=np.float64) + 1e6)
        assert session._ts.size > 4096
        slotted, frame = session.advance(problem)
        assert frame.full_reason == "ranker_prune"
        assert session._ts.size < 4096, "rankers rebuilt from live rows"
        frames.append((slotted, frame))
    _assert_problems_equal(frames[1][0], frames[0][0], "prune")
    _assert_frames_equal(frames[1][1], frames[0][1], "prune")

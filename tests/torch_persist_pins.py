"""The JAX package's pins of chip_smoke.py's phase 24 (b)-(d).

- (b) the durable storm: ``scenarios.durable_storm`` over Kueue's
  baseline storm at full size (15,000 workloads) with the JAX package's
  engine (scheduler-backed, ``mesh_mode="off"``): each drain's plan
  record, the checkpoint's workloads, the WAL's records and bytes, and
  the sha256 of the live store's ``canonical_dump``;
- (c) the crash harness's ``--solver`` no-crash dump (``python -m
  kueue_oss_tpu.persist.crashtest --phase run --solver``): its sha256
  and size;
- (d) the durable TAS drain: ``scenarios.durable_tas`` at phase 12's
  1,500 workloads through the JAX ``Scheduler(solver="auto")``: the
  cycles, the committed-store digest, the WAL's records and bytes and
  the dump's sha256.

Run ``JAX_PLATFORMS=cpu python tests/torch_persist_pins.py`` to print
them (several minutes on the CPU: the storm's FULL drains at full
size). ``--small`` runs (b) at a twentieth of one cohort, the shape the
CPU tests hold the port to (tests/test_torch_persist.py runs the same
runs in both packages).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def jax_durable():
    from kueue_oss_tpu.api import types
    from kueue_oss_tpu.core.queue_manager import QueueManager
    from kueue_oss_tpu.core.store import Store
    from kueue_oss_tpu.persist import (
        InvariantAuditor,
        PersistenceManager,
        canonical_dump,
    )
    from kueue_oss_tpu.scheduler.scheduler import Scheduler
    from kueue_oss_tpu.solver.engine import SolverEngine
    from kueue_oss_tpu_torch.scenarios import Durable

    return Durable(types, Store, QueueManager, Scheduler, SolverEngine,
                   PersistenceManager, InvariantAuditor, canonical_dump,
                   sched_kw={}, engine_kw={"mesh_mode": "off"},
                   engine_attrs={"relax_enabled": False})


def drain_record(store, result) -> dict:
    from kueue_oss_tpu_torch.scenarios import preempt_plan_digest

    return {"admitted": result.admitted, "evicted": result.evicted,
            "rounds": result.rounds,
            "held": sum(1 for w in store.workloads.values()
                        if w.is_quota_reserved),
            "digest": preempt_plan_digest(store, result)}


def storm_pins(**store_kw) -> dict:
    """(b). The drain records are taken after the run, so the first
    two hold the store as it ends (``held`` of the last drain)."""
    from kueue_oss_tpu_torch.scenarios import durable_storm

    with tempfile.TemporaryDirectory() as d:
        out = durable_storm(jax_durable(), d, **store_kw)
    return {"drains": [{"admitted": r.admitted, "evicted": r.evicted,
                        "rounds": r.rounds} for r, _ in out["drains"]],
            **{k: out[k] for k in (
                "workloads_seeded", "workloads_checkpointed", "finished",
                "wal_records", "wal_bytes", "checkpoint_bytes",
                "dump_sha256", "dump_bytes", "recovered_identical",
                "audit_violations")}}


def crash_pin() -> dict:
    """(c)."""
    with tempfile.TemporaryDirectory() as d:
        subprocess.run([sys.executable, "-m", "kueue_oss_tpu.persist.crashtest",
                        "--dir", d, "--phase", "run", "--solver"],
                       cwd=ROOT, check=True, capture_output=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
        with open(os.path.join(d, "final.dump"), "rb") as f:
            data = f.read()
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}


def tas_pins() -> dict:
    """(d)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_scheduler_pins import committed_store_digest

    from kueue_oss_tpu_torch.scenarios import durable_tas

    with tempfile.TemporaryDirectory() as d:
        out = durable_tas(jax_durable(), d)
    store = out["store"]
    return {"cycles": out["cycles"],
            "held": sum(1 for w in store.workloads.values()
                        if w.is_quota_reserved),
            "digest": committed_store_digest(store),
            **{k: out[k] for k in ("wal_records", "wal_bytes",
                                   "dump_sha256", "dump_bytes",
                                   "recovered_identical",
                                   "audit_violations")}}


if __name__ == "__main__":
    if sys.argv[1:] == ["--small"]:
        print(json.dumps({"storm_small": storm_pins(
            n_cohorts=1, cqs_per_cohort=2, scale=0.05)}))
        sys.exit(0)
    print(json.dumps({"crash_solver": crash_pin()}), flush=True)
    print(json.dumps({"tas": tas_pins()}), flush=True)
    print(json.dumps({"storm": storm_pins()}), flush=True)
